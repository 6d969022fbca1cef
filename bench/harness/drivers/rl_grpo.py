"""Synchronous GRPO iterations through ``RLTrainer.iteration`` on the
single-device colocate-all plan: GEN (the single-wave rollout when the
samples fit a decode wave), INF (the frozen reference's log-probs),
TRAIN (autograd over plain attention, Adam), weight sync.

Set-up builds the one trainer, hands it the benchmark's weights and runs
its first ``check_iterations`` iterations through the window's own call
and feed, on prompts that all differ; they warm every shape the window
uses.  While they run the harness keeps what the check compares: each
iteration's sampled sequences, GEN's log-probs of them, INF's reference
log-probs, the advantages and the loss, the first gradient as Adam got it
(its first moment over 1 - beta1) and the change of the parameters over
those iterations, each by leaf (a block leaf by layer).

The check (``follow``) is the plain reference taking the same steps from
the same weights, in its own float32: it reads the program's sampled
tokens (they cannot be drawn again) and works out everything else itself.
"""
from __future__ import annotations

import statistics
import sys
import time

import numpy as np
import torch

from bench.harness import traffic, weights
from bench.reference import grpo

GEN, INF, TRAIN = "actor_generation", "reference_inference", "actor_training"


class Task:
    """The mix's prompts come from the harness; the reward is its rule on
    the response up to and including the first EOS."""

    def __init__(self, mix: dict):
        self.mix = mix
        self.prompt_len = int(mix["prompt_len"])

    def reward_batch(self, answers, generated) -> np.ndarray:
        eos, k = int(self.mix["eos_token"]), int(self.mix["reward"]["classes"])
        out = []
        for a, g in zip(answers, np.asarray(generated)):
            stop = np.flatnonzero(g == eos)
            g = g[:stop[0] + 1] if len(stop) else g
            out.append(float(np.mean(g % k == a)))
        return np.asarray(out, np.float32)


def slices(tree: dict, prefix: str = ""):
    """(name, tensor) of every leaf; a stacked block leaf by layer."""
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from slices(v, path + "/")
        elif path.startswith("blocks/"):
            for r in range(v.shape[0]):
                yield f"{path}[{r}]", v[r]
        else:
            yield path, v


def norms(tree: dict, scale: float = 1.0) -> dict:
    return {n: float(t.float().norm()) * scale for n, t in slices(tree)}


def diff_norms(a: dict, b: dict) -> dict:
    sb = dict(slices(b))
    return {n: float((t.float() - sb[n].float()).norm())
            for n, t in slices(a)}


class Driver:
    def __init__(self, cell, seed: int, device, family, reference):
        self.cell, self.seed, self.device = cell, seed, device
        self.family, self.ref = family, reference
        self.mix, self.c = cell.traffic, cell.config
        self.capture = None
        # the set-up's iterations take the first units of the seed's feed
        self.first_unit = int(self.mix["check_iterations"])

    # -- the program ----------------------------------------------------
    def initial_params(self):
        return weights.make_params(self.family.param_specs(self.c),
                                   self.seed, torch.float32, self.device)

    def setup(self) -> None:
        from repro_torch.optim import adam
        from repro_torch.rl.trainer import RLConfig, RLTrainer
        mix, rl = self.mix, self.mix["rl"]
        cfg = self.family.port_config(self.c, "float32")
        a = adam.AdamConfig(lr=rl["lr"])
        for key, want in mix["adam"].items():
            if getattr(a, key) != want:
                raise ValueError(f"the port's Adam {key} is "
                                 f"{getattr(a, key)}, the mix states {want}")
        self.trainer = RLTrainer(
            cfg, RLConfig(algorithm=rl["algorithm"],
                          clip_eps=rl["clip_eps"], kl_beta=rl["kl_beta"],
                          n_rollouts=int(mix["rollouts"]),
                          max_new_tokens=int(mix["max_new_tokens"]),
                          temperature=float(mix["temperature"]),
                          whiten_advantages=rl["whiten_advantages"],
                          lr=rl["lr"]),
            Task(mix), seed=int(self.seed) % (1 << 31), device=self.device)
        w0 = self.initial_params()
        self.trainer.load_state_tree({
            "actor": w0, "ref": _clone(w0),
            "actor_opt": adam.init_adam_state(w0, a), "gen_params": w0,
            "weight_version": torch.tensor(0, dtype=torch.int32)})
        self.rng = torch.Generator(device=self.device).manual_seed(
            int(self.seed) % (1 << 63))
        self._wrap()
        self.capture = []
        for k in range(int(mix["check_iterations"])):
            self.capture.append({})
            self.unit(k)
            if k == 0:
                self.program_grad1 = norms(self.trainer.actor_opt["m"],
                                           1.0 / (1.0 - a.beta1))
        self.program_delta = diff_norms(self.trainer.actor, w0)
        self.captured, self.capture = self.capture, None

    def _wrap(self) -> None:
        """Keep INF's and TRAIN's inputs and outputs while ``capture`` is
        set; pass everything through unchanged."""
        tr = self.trainer
        ref_logp, actor_step = tr._ref_logp, tr._actor_step

        def _ref_logp(params, sequences, gen_start):
            lp = ref_logp(params, sequences, gen_start)
            if self.capture is not None:
                self.capture[-1]["inf_lp"] = lp.detach().cpu()
            return lp

        def _actor_step(params, opt_state, batch, gen_start):
            out = actor_step(params, opt_state, batch, gen_start)
            if self.capture is not None:
                self.capture[-1].update(
                    {k: batch[k].detach().cpu() for k in
                     ("sequences", "logp_old", "advantages", "mask")})
                self.capture[-1]["loss"] = float(out[2]["loss"])
            return out

        tr._ref_logp, tr._actor_step = _ref_logp, _actor_step

    def unit(self, k: int) -> dict:
        from repro_torch.device import synchronize
        b = traffic.rl_batch(self.mix, self.c["vocab_size"], self.seed, k)
        if self.capture is not None:
            self.capture[-1]["answers"] = torch.as_tensor(b.answers)
        t0 = time.perf_counter()
        self.trainer.iteration(b.prompts, b.answers, self.rng)
        synchronize(self.device)
        t1 = time.perf_counter()
        tasks = {}
        eng = self.trainer.engine
        last = max(e.iteration for e in eng.timeline)
        ev = [e for e in eng.timeline if e.iteration == last]
        for e in ev:
            name = eng.wf.task(e.task).name
            tasks[name] = tasks.get(name, 0.0) + (e.time if e.kind == "end"
                                                  else -e.time)
        return {"t0": t0, "t1": t1, "tasks": tasks,
                "samples": int(self.mix["prompts"] * self.mix["rollouts"])}

    def attempted_failed(self, units):
        return sum(u["samples"] for u in units), 0

    def free(self) -> None:
        import gc
        self.trainer = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    # -- the reference ----------------------------------------------------
    def follow(self, mode: str = "fp32") -> dict:
        """The reference's own ``check_iterations`` steps on the program's
        sampled tokens.  ``mode``: "fp32" the reference; "tf32" the
        control (the same in TF32); "half" and "token" plant a fault in
        the stand-in (the loss's mean over half of the rows; GEN's
        log-probs read at altered tokens)."""
        prev = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = mode == "tf32"
        try:
            return self._follow(mode)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = prev

    def _follow(self, mode: str) -> dict:
        mix, rl, ad = self.mix, self.mix["rl"], self.mix["adam"]
        P, G = int(mix["prompt_len"]), int(mix["rollouts"])
        eos = int(mix["eos_token"])
        w0 = self.initial_params()
        names = [n for n, _ in slices(w0)]
        leaves = _flat(w0)
        params = [t.detach().clone() for t in leaves]
        m = [torch.zeros_like(t) for t in params]
        v = [torch.zeros_like(t) for t in params]
        out = {"gen_lp": [], "inf_lp": [], "adv": [], "loss": []}
        rows_per_block = 8
        for k, cap in enumerate(self.captured):
            seq = cap["sequences"].to(self.device)
            gen = seq[:, P:]
            mask = grpo.alive_mask(seq[:, P - 1], gen, eos)
            answers = cap["answers"].repeat_interleave(G).to(self.device)
            scores = grpo.reward(mix["reward"], answers, gen, mask)
            lp_ref = self._logprobs(_unflat(w0, leaves), seq, gen, P)
            lp_old = lp_ref if k == 0 else self._logprobs(
                _unflat(w0, params), seq, gen, P)
            gen_lp = lp_old
            if mode == "token":
                gen_lp = self._logprobs(_unflat(w0, params), seq,
                                        (gen + 1) % self.c["vocab_size"], P)
            adv = grpo.advantages(scores, lp_old, lp_ref, mask, G,
                                  rl["kl_beta"], rl["whiten_advantages"])
            rows = torch.arange(seq.shape[0], device=self.device)
            if mode == "half":
                rows = rows[::2]
            n = mask[rows].sum().clamp(min=1.0)
            grads = [torch.zeros_like(t) for t in params]
            loss = 0.0
            for i in range(0, len(rows), rows_per_block):
                r = rows[i:i + rows_per_block]
                ps = [t.detach().requires_grad_(True) for t in params]
                lp = self._logprobs(_unflat(w0, ps), seq[r], gen[r], P)
                ls = grpo.policy_loss_sum(lp, lp_old[r], adv[r], mask[r],
                                          rl["clip_eps"]) / n
                gs = torch.autograd.grad(ls, ps, allow_unused=True)
                for g_acc, g in zip(grads, gs):
                    if g is not None:
                        g_acc += g
                loss += float(ls.detach())
            grads = grpo.clip_by_global_norm(grads, ad["grad_clip_norm"])
            if k == 0:
                out["grad1"] = {nm: float(g.norm()) for nm, g in
                                zip(names, _slices(w0, grads))}
            params, m, v = grpo.adam(params, grads, m, v, k + 1, rl["lr"],
                                     ad["beta1"], ad["beta2"], ad["eps"])
            out["gen_lp"].append((gen_lp * mask).cpu())
            out["inf_lp"].append((lp_ref * mask).cpu())
            out["adv"].append((adv * mask).cpu())
            out["loss"].append(loss)
        out["delta"] = {nm: float((a - b).norm()) for nm, a, b in zip(
            names, _slices(w0, params), _slices(w0, leaves))}
        return out

    def _logprobs(self, params, seq, tok, P: int, block: int = 8):
        """Log-probs of ``tok`` [B, N] after each prefix of ``seq`` (the
        reference's forward, in row blocks)."""
        outs = []
        ctx = torch.enable_grad() if any(
            t.requires_grad for t in _leaves(params)) else torch.no_grad()
        with ctx:
            for i in range(0, seq.shape[0], block):
                h = self.ref.hidden(params, self.c, seq[i:i + block])
                lg = self.ref.logits(params, self.c, h[:, P - 1:-1])
                outs.append(grpo.token_logprobs(lg, tok[i:i + block]))
        return torch.cat(outs)

    def program_readings(self) -> dict:
        cap = self.captured
        return {"gen_lp": [c["logp_old"] * c["mask"] for c in cap],
                "inf_lp": [c["inf_lp"] * c["mask"] for c in cap],
                "adv": [c["advantages"] * c["mask"] for c in cap],
                "loss": [c["loss"] for c in cap],
                "grad1": self.program_grad1, "delta": self.program_delta}

    def readings(self, units, prec: str = "fp32") -> dict:
        """The compared numbers of the program (``prec`` "fp32") or of a
        stand-in put in its place (``prec`` one of ``follow``'s modes)
        against the reference."""
        if getattr(self, "_reference", None) is None:
            self._reference = self.follow("fp32")
        got = self.program_readings() if prec == "fp32" else self.follow(prec)
        g1 = self._reference["grad1"]
        med = statistics.median(g1.values())
        quiet = sorted(n for n, v in g1.items() if v < 1e-3 * med)
        print(f"leaves left out of the change (reference gradient under "
              f"1e-3 of the median leaf's): {len(quiet)} {quiet[:4]}",
              file=sys.stderr)
        return compare(got, self._reference)


def compare(got: dict, ref: dict) -> dict:
    """Largest gaps: log-probs, advantages and loss absolute; the first
    gradient and the change of the parameters by leaf, the gap of the two
    norms over the larger of the reference's norm of that leaf and of the
    median leaf.  The change leaves out leaves whose reference gradient is
    under a thousandth of the median leaf's (rounding moves them)."""
    def worst(a, b):
        return max(float((x.float() - y.float()).abs().max())
                   for x, y in zip(a, b))

    def by_leaf(a: dict, b: dict, keep) -> float:
        med = statistics.median(b.values())

        def gap(n):
            d = max(b[n], med)
            return abs(a[n] - b[n]) / d if d > 0 else float(a[n] != b[n])
        return max(gap(n) for n in b if keep(n))

    g1 = ref["grad1"]
    g_med = statistics.median(g1.values())
    return {"gen_logprob_gap": worst(got["gen_lp"], ref["gen_lp"]),
            "inf_logprob_gap": worst(got["inf_lp"], ref["inf_lp"]),
            "advantage_gap": worst(got["adv"], ref["adv"]),
            "loss_gap": max(abs(a - b) for a, b in
                            zip(got["loss"], ref["loss"])),
            "grad1_leaf_gap": by_leaf(got["grad1"], g1, lambda n: True),
            "change_leaf_gap": by_leaf(got["delta"], ref["delta"],
                                       lambda n: g1[n] >= 1e-3 * g_med)}


def _clone(tree):
    return {k: _clone(v) if isinstance(v, dict) else v.clone()
            for k, v in tree.items()}


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def _flat(tree) -> list:
    return list(_leaves(tree))


def _unflat(like: dict, flat: list) -> dict:
    it = iter(flat)

    def build(t):
        return {k: build(v) if isinstance(v, dict) else next(it)
                for k, v in t.items()}
    return build(like)


def _slices(like: dict, flat: list):
    return [t for _, t in slices(_unflat(like, flat))]
