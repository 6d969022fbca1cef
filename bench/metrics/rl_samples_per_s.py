"""rl_samples_per_s: every sample trained in the window's whole GRPO
iterations (a prompt's response; a group of G per prompt is G samples)
over the time from the first iteration's start to the last one's end."""
from bench.harness import stats


def read(run):
    return stats.rate((u["samples"] for u in run.units),
                      ((u["t0"], u["t1"]) for u in run.units))
