"""rl.mfu: the model FLOPs the window's iterations needed, over the
window's time at the card's fp32 peak (TF32 is off in the port), in %.

Per iteration, counted from the mix and the configuration: 2 N FLOPs per
GEN and INF token and 6 N per trained token (N: the matrix-product
parameters, the LM head included), and the attention of the actual
sequences (causal prefill; each decode token over its context; three
times the forward's for training).  Recomputation is not counted."""
from bench.metrics import work


def iteration_flops(fam, c, mix) -> float:
    B = mix["prompts"] * mix["rollouts"]
    P, N = mix["prompt_len"], mix["max_new_tokens"]
    n2 = 2.0 * fam.matmul_params(c)
    S = P + N
    gen = P * n2 + fam.prefill_mixer_flops(c, P) + sum(
        n2 + fam.decode_mixer_flops(c, P + t) for t in range(1, N))
    forward = S * n2 + fam.prefill_mixer_flops(c, S)
    return B * (gen + forward + 3 * forward)


def read(run):
    t0, t1 = run.span
    f = iteration_flops(run.family, run.cell.config, run.cell.traffic)
    return 100.0 * len(run.units) * f / ((t1 - t0) * work.PEAK_FP32)
