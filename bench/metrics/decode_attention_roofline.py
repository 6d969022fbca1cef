"""decode_attention_roofline: the least time the card needs for the
window's decode attention over the device time of the kernels named
``KERNELS`` (``csrc/decode_attention.cu``), in %.  The least time is
bytes at HBM speed: a request emitting its token t (t >= 1; token 0
comes from the prefill) reads its padded prompt width plus t K and V
rows, its Q and its output, every layer."""
from bench.metrics import work

KERNELS = ("decode_kernel",)


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    c, el = run.cell.config, 2 if run.cell.dtype == "bfloat16" else 4
    bound = sum(work.decode_bytes(c, u["pad_to"] + t, el)
                for u in run.units for n in u["gen_lens"]
                for t in range(1, n)) / work.HBM
    return 100.0 * bound / spent
