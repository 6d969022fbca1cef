"""RL-side helpers the serving path needs (single-wave rollout)."""
