"""gen.mfu: the model FLOPs the window's requests needed, over the
window's time at the card's bf16 peak, in %: per request the prefill of
its padded prompt width (2 N a token and the mixer's prefill: causal
attention, or the RWKV6 scan's operations as the sub-chunked algorithm
counts them) and each decode token after the first (2 N and the mixer's
step over its context)."""
from bench.metrics import work


def request_flops(fam, c, P: int, n: int) -> float:
    n2 = 2.0 * fam.matmul_params(c)
    return P * n2 + fam.prefill_mixer_flops(c, P) + sum(
        n2 + fam.decode_mixer_flops(c, P + t) for t in range(1, n))


def read(run):
    fam, c = run.family, run.cell.config
    f = sum(request_flops(fam, c, u["pad_to"], n)
            for u in run.units for n in u["gen_lens"])
    t0, t1 = run.span
    return 100.0 * f / ((t1 - t0) * work.PEAK_BF16)
