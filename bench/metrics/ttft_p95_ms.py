"""ttft_p95_ms: the nearest-rank 95th percentile, over every request of
every batch of the window, of the time from the batch's start (every
request queued then) to the request's first token, by the engine's own
stamps (``measure_ttft``)."""
from bench.harness import stats


def read(run):
    return 1e3 * stats.p95([t for u in run.units for t in u["ttft"]])
