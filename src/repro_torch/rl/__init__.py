"""RL side of the port: rollouts, objectives, advantages, rewards, weight sync and the plan-driven trainer."""
