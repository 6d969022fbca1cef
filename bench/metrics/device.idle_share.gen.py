"""device.idle_share.gen: 1 - busy / wall over the traced window's whole
engine batches, in %: busy is the union of the card's kernel, copy and
memset intervals under ``torch.profiler``."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
