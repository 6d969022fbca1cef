"""Offline engine batches through ``repro_torch.genserve.adapter.generate``.

A unit is one batch of the mix: every request queued at its start, as RL
GEN submits them, served greedily by the continuous-batching engine at
the mix's wave with one-shot admission and a contiguous cache, the
engine's time-to-first-token stamps on (``measure_ttft``).

Check: once the window has closed, a sample of the window's requests
drawn from the seed, with the one that served the most tokens in it.  The
plain reference runs once over each prompt (the padded row the engine
prefilled) and its served tokens; the number compared is the widest gap
by which a served token's logit lies below the reference's best logit at
that position (``max_logit_gap``); beside it the widest gap between the
log-prob the engine returned for a served token and the reference's
(``max_logprob_gap``: the slot's logits at its own position, whether or
not an error flips the greedy pick); and every request has to have
served its whole budget (``short_requests``: no EOS is set, so a
shorter response is a lost one).
"""
from __future__ import annotations

import time

import torch

from bench.harness import stats as stats_mod, traffic, weights


def served_gaps(ref, c, params, rows, against=None):
    """(widest gap below the reference's best logit, widest log-prob gap)
    of the served tokens in ``rows`` ((prompt row, tokens, log-probs)).
    With ``against`` ("fp8") the tokens and log-probs are those of the
    reference in that lower precision, put in the program's place: its
    greedy tokens at the same positions and their log-probs."""
    P = len(rows[0][0])
    n_max = max(len(t) for _, t, _ in rows)
    seq = torch.zeros((len(rows), P + n_max), dtype=torch.int64)
    for i, (p, t, _) in enumerate(rows):
        seq[i, :P] = torch.as_tensor(p)
        seq[i, P:P + len(t)] = torch.as_tensor(t)
    dev = params["final_norm"]["scale"].device
    seq = seq.to(dev)
    gap = lp_gap = 0.0
    with torch.no_grad():
        h = ref.hidden(params, c, seq, "fp32")
        hc = ref.hidden(params, c, seq, against) if against else None
        for i, (_, t, lp) in enumerate(rows):
            pos = slice(P - 1, P - 1 + len(t))
            lg = ref.logits(params, c, h[i, pos], "fp32")
            if against:
                low = ref.logits(params, c, hc[i, pos], against)
                tok = low.argmax(-1)
                lp = torch.log_softmax(low, -1).gather(-1, tok[:, None])[:, 0]
            else:
                tok = torch.as_tensor(t, device=dev)
                lp = torch.as_tensor(lp, device=dev)
            best = lg.max(-1).values
            mine = lg.gather(-1, tok[:, None])[:, 0]
            gap = max(gap, float((best - mine).max()))
            ref_lp = torch.log_softmax(lg, -1).gather(-1, tok[:, None])[:, 0]
            lp_gap = max(lp_gap, float((ref_lp - lp).abs().max()))
    return gap, lp_gap


class Driver:
    def __init__(self, cell, seed: int, device, family, reference):
        self.cell, self.seed, self.device = cell, seed, device
        self.family, self.ref = family, reference
        self.mix, self.c = cell.traffic, cell.config
        self.first_unit = 0

    def setup(self) -> None:
        from repro_torch.device import resolve_dtype
        from repro_torch.rl.rollout import SamplerConfig
        self.cfg = self.family.port_config(self.c, self.cell.dtype)
        self.params = weights.make_params(
            self.family.param_specs(self.c), self.seed,
            resolve_dtype(self.cell.dtype), self.device)
        self.sampler = SamplerConfig(
            max_new_tokens=int(self.mix["gen_len"]["hi"]), temperature=0.0,
            eos_token=None, greedy=True)
        self._serve(traffic.warm_batch(self.mix, self.c["vocab_size"],
                                       self.seed))

    def _serve(self, b: traffic.GenBatch):
        from repro_torch.device import synchronize
        from repro_torch.genserve import adapter
        with torch.inference_mode():
            ro, stats = adapter.generate(
                self.params, self.cfg, torch.as_tensor(b.prompts,
                                                       device=self.device),
                None, self.sampler, wave=int(self.mix["wave"]),
                decode_chunk=int(self.mix["decode_chunk"]),
                gen_lens=b.gen_lens.tolist(),
                prompt_lens=b.prompt_lens.tolist(), fast_path=False,
                measure_ttft=True, device=self.device)
        synchronize(self.device)
        return ro, stats

    def unit(self, k: int) -> dict:
        b = traffic.gen_batch(self.mix, self.c["vocab_size"], self.seed, k)
        t0 = time.perf_counter()
        ro, stats = self._serve(b)
        t1 = time.perf_counter()
        served = ro["mask"].sum(1).to(torch.int64).cpu().numpy()
        tokens = ro["gen_tokens"].cpu().numpy()
        logprobs = ro["logprobs"].cpu().numpy()
        return {"t0": t0, "t1": t1, "tokens": int(served.sum()),
                "requests": len(b.gen_lens),
                "short": int((served < b.gen_lens).sum()),
                "ttft": [float(v) for v in stats["ttft"].values()],
                "ttft_p95_s": stats_mod.p95(list(stats["ttft"].values())),
                "slot_steps": stats["slot_steps"]
                + stats["prefill_slot_steps"],
                "decode_steps": stats["decode_steps"],
                "wave": stats["wave"], "pad_to": b.prompts.shape[1],
                "gen_lens": [int(n) for n in served],
                "rows": [(b.prompts[i], tokens[i, :served[i]],
                          logprobs[i, :served[i]])
                         for i in range(len(served))]}

    def attempted_failed(self, units):
        return (sum(u["requests"] for u in units),
                sum(u["short"] for u in units))

    def sample(self, units):
        """The checked requests: drawn from the seed over the window's,
        the one that served the most tokens first."""
        rows = [r for u in units for r in u["rows"]]
        longest = max(range(len(rows)), key=lambda i: len(rows[i][1]))
        g = traffic.rng(self.seed, 0, stream=2)
        rest = [i for i in g.permutation(len(rows)) if i != longest]
        n = int(self.mix["check_requests"])
        return [rows[i] for i in [longest] + rest[:n - 1]]

    def free(self) -> None:
        """The engine keeps no state between batches: the weights (the
        benchmark's, not the program's) stay for the reference."""
        torch.cuda.empty_cache() if self.device.type == "cuda" else None

    def readings(self, units, prec: str = "fp32") -> dict:
        """The compared numbers; ``prec`` "fp8": the control's, the
        reference in the lower precision put in the program's place."""
        rows = self.sample(units)
        gap, lp_gap = served_gaps(self.ref, self.c, self.params, rows,
                                  against=None if prec == "fp32" else prec)
        return {"max_logit_gap": gap, "max_logprob_gap": lp_gap,
                "short_requests": float(sum(u["short"] for u in units))}
