"""rwkv6_scan_roofline: the least time the card needs for the window's
RWKV6 prefill scans over the device time of the kernels named
``KERNELS`` (``csrc/rwkv6_scan.cu``), in %.  Per request one scan of its
padded prompt width, every layer, counted by ``work.rwkv_work`` (the
sub-chunked algorithm, chunks of 64): the larger of its operations at
the fp32 peak and its bytes at HBM speed."""
from bench.metrics import work

KERNELS = ("rwkv6_chunked",)
CHUNK = 64


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    c = run.cell.config
    L, N = c["num_hidden_layers"], c["head_size"]
    H = c["hidden_size"] // N
    bound = 0.0
    for u in run.units:
        nbytes, flops, _ = work.rwkv_work(1, u["pad_to"], H, N, CHUNK)
        bound += len(u["gen_lens"]) * L * max(flops / work.PEAK_FP32,
                                              nbytes / work.HBM)
    return 100.0 * bound / spent
