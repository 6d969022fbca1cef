"""Synthetic RL task and prompt stream (numpy)."""
