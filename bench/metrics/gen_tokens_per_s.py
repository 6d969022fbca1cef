"""gen_tokens_per_s: every valid generated token of the window's whole
engine batches over the time from the first batch's start to the last
one's end."""
from bench.harness import stats


def read(run):
    return stats.rate((u["tokens"] for u in run.units),
                      ((u["t0"], u["t1"]) for u in run.units))
