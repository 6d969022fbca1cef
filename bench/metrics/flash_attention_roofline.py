"""flash_attention_roofline: the least time the card needs for the
window's prefill attention over the device time of the kernels named
``KERNELS`` (``csrc/flash_attention.cu``: the bf16 tensor-core kernel
and the fp32 one), in %.  Per request, its causal prefill at the padded
width: the larger of its FLOPs at the bf16 peak and its Q, K, V and O
bytes at HBM speed, every layer."""
from bench.metrics import work

KERNELS = ("flash_tc", "flash_fwd")


def read(run):
    if run.trace is None:
        return None
    spent = run.trace.kernel_seconds(KERNELS)
    if spent <= 0:
        return None
    c, el = run.cell.config, 2 if run.cell.dtype == "bfloat16" else 4
    bound = sum(work.flash_bound_s(c, u["pad_to"], el)
                for u in run.units for _ in u["gen_lens"])
    return 100.0 * bound / spent
