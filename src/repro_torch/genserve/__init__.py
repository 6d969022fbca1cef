"""Continuous-batching generation server (one-shot admission)."""
