"""Sharded plan execution over a world of ranks: the port of
``examples/sharded_exec.py``.

A gen | rest disaggregated plan over 8 plan devices: generation on plan
devices 0-3 at DP=2/TP=2, the inference and training tasks on 4-7
(actor training DP=2/TP=2, the inference tasks DP=4), asynchronous
GRPO.  It folds onto a world of 8 ranks (``parallel.dist``: one process
per device) with GEN and TRAIN on disjoint rank sets, so the engine's
overlapped walk decodes iteration t+1 on ranks 0-3 while ranks 4-7 train
on t's bundle, and onto a world of one rank (every group folded onto
one device, collisions reported, the stage walk serialized) as the
unsharded baseline.  With more rollout rows than one decode wave (or
``prefill_chunk`` / ``spec_k``) GEN runs on genserve on the GEN mesh
(``make_trainer``; ``rank_main``'s ``variants``).

``rank_main`` is what each rank runs (``dist.spawn`` or a launcher's
world); ``run`` drives a trainer over a prompt stream that every world
sees alike; ``main`` spawns the 8-rank world, runs the world-1 baseline
in this process and holds the example's assertions:

- zero folding collisions, GEN and TRAIN on disjoint ranks, the train
  mesh (2, 2), ``overlap_active`` and ``overlap_honest`` 1.0;
- the asynchronous one-step staleness on every trained record;
- greedy tokens identical to the world-1 run; sampled tokens identical
  while GEN decodes with the initial weights (every GEN rank draws the
  whole batch's random numbers), and at least ``AGREEMENT`` of them
  after the first weight sync: Adam's first step divides each gradient
  by its magnitude, so the fp32 reduction-order noise of the TP/DP
  partial sums in a near-zero gradient moves its parameter by up to
  2*lr, and a sample that falls at a boundary of the categorical may
  land on the next token; greedy masks identical too;
- with ``replay`` (``rank_main``), each sharded GEN against a
  world-of-one GEN replayed on the GEN ranks' own weights and generator
  state: at least ``REPLAY_AGREEMENT`` of the tokens;
- GRPO losses within ``--loss-rtol`` / ``--loss-atol`` of the world-1
  run, with a loss that is not zero;
- weight-sync bytes equal to ``tree_bytes(actor)``, and after every
  iteration the GEN ranks' weights equal the actor bit for bit
  (``synced_identical``).

Run:  python -m repro_torch.launch.sharded_exec --device cpu [--json]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import enumerate as enum_mod
from repro_torch.core import topology, workflow
from repro_torch.core.plan import check_constraints
from repro_torch.data.synthetic import AdditionTask, VOCAB_SIZE
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import dist
from repro_torch.rl.trainer import RLConfig, RLTrainer

WORLD = 8
AGREEMENT = 0.95   # sampled tokens identical after the first sync
REPLAY_AGREEMENT = 1.0   # ... and against a world-of-one GEN replayed on
#                          the sharded GEN's own weights (``_gen_replay``)


def tiny_cfg() -> ModelConfig:
    return ModelConfig(name="sharded-tiny", n_layers=2, d_model=64,
                       n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
                       vocab_size=VOCAB_SIZE, dtype="float32")


def build_plan_8dev(wf):
    """gen | rest over 8 plan devices: generation on 0-3, the inference
    and training tasks on 4-7, GEN and TRAIN explicitly DP=2/TP=2."""
    topo = topology.build_testbed("single_region",
                                  counts={"A100": 4, "L4": 4})
    grouping = next(g for g in enum_mod.priority_groupings(wf)
                    if len(g) == 2 and any(
                        wf.task(t).kind == workflow.TaskKind.GEN
                        for t in min(g, key=len)))
    gen_gi = next(gi for gi, g in enumerate(grouping)
                  if any(wf.task(t).kind == workflow.TaskKind.GEN
                         for t in g))
    parallel = {}
    for t in range(wf.n_tasks):
        kind = wf.task(t).kind
        parallel[t] = (2, 1, 2) if kind in (workflow.TaskKind.GEN,
                                            workflow.TaskKind.TRAIN) \
            else (4, 1, 1)
    order = list(range(8)) if gen_gi == 0 else \
        list(range(4, 8)) + list(range(4))
    plan = enum_mod.build_plan(topo, wf, grouping, [4, 4], order,
                               parallel=parallel)
    ok, msg = check_constraints(topo, wf, plan)
    assert ok, msg
    return topo, plan


def make_trainer(cfg: ModelConfig, device, *, greedy: bool = False,
                 n_rollouts: int = 4, max_new_tokens: int = 4,
                 overlap: Optional[bool] = None, prefill_chunk: int = 0,
                 spec_k: int = 0):
    """The example's trainer: asynchronous GRPO, whitening off (it
    normalizes by the in-group advantage std, which amplifies TP
    reduction-order noise to O(1) when a group's rewards are nearly
    uniform).  GEN runs on genserve when the rollout rows exceed one
    decode wave, with ``prefill_chunk`` (chunked admission) or with
    ``spec_k`` (speculative decoding)."""
    task = AdditionTask(max_operand=9)
    rl = RLConfig(algorithm="grpo", n_rollouts=n_rollouts,
                  max_new_tokens=max_new_tokens, asynchronous=True,
                  greedy=greedy, whiten_advantages=False,
                  prefill_chunk=prefill_chunk, spec_k=spec_k)
    wf = workflow.make_workflow(
        "grpo", workflow.LLMSpec.from_model_config(cfg), synchronous=False,
        n_rollouts=rl.n_rollouts, seq_in=task.prompt_len,
        seq_out=rl.max_new_tokens, global_batch=1)
    topo, plan = build_plan_8dev(wf)
    return RLTrainer(cfg, rl, task, seed=0, plan=plan, topo=topo, wf=wf,
                     device=device, overlap=overlap)


def run(trainer, iters: int, batch: int = 4, seed: int = 0):
    """Same prompt and generator stream for every world: the runs are
    comparable iteration by iteration.  Returns (metrics, (the pending
    bundle's gen tokens after each iteration, the weight version they
    were decoded with, whether the GEN weights equal the actor after the
    iteration: ``synced_identical``, the gen masks), wall seconds
    each."""
    task = trainer.task
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=trainer.device).manual_seed(7)
    metrics, tokens, versions, synced, walls = [], [], [], [], []
    masks = []
    for _ in range(iters):
        prompts, answers = task.sample_batch(rng, batch)
        t0 = time.monotonic()
        metrics.append(trainer.iteration(prompts, answers, gen))
        walls.append(time.monotonic() - t0)
        pend = trainer.engine.pipeline._pending
        tokens.append(pend["rollout"]["gen_tokens"].cpu().numpy()
                      if pend is not None else None)
        masks.append(pend["rollout"]["mask"].cpu().numpy()
                     if pend is not None else None)
        versions.append(pend["gen_version"] if pend is not None else None)
        synced.append(synced_identical(trainer))
    return metrics, (tokens, versions, synced, masks), walls


def synced_identical(trainer) -> Optional[bool]:
    """Whether the GEN placement's weights equal the trained actor bit
    for bit, right after a weight sync (or, after the pipeline fill, the
    initial weights on both sides).  Each side gathers its leaves on
    its own ranks; the train lead broadcasts each full leaf over the
    sync group, and the GEN ranks compare.  Every rank calls it; True or
    False on the GEN ranks, None on the others.  Leaf by leaf, so at
    most two full leaves are held beside the trees."""
    from repro_torch.parallel import sharding as sh
    from repro_torch.tree import tree_leaves
    eng = trainer.engine
    gen_pl = eng.placements[eng.ctx.gen_task]
    train_pl = eng.placements[eng.ctx.actor_train]
    actor = tree_leaves(trainer.actor) if train_pl.here else None
    gen = tree_leaves(trainer.gen_params) if gen_pl.here else None
    group = eng.ctx.sync_group
    members = set(range(dist.world_size())) if group is None else \
        set(torch.distributed.get_process_group_ranks(group))
    same = True
    for i, meta in enumerate(tree_leaves(trainer.meta["actor"])):
        want = sh.full(actor[i]) if train_pl.here else None
        got = sh.full(gen[i]) if gen_pl.here else None
        if dist.multi() and dist.rank() in members:
            want = dist.broadcast_tensor(want, train_pl.lead, meta.shape,
                                         meta.dtype, trainer.device, group)
        if gen_pl.here:
            same = same and torch.equal(got, want)
    return same if gen_pl.here else None


def _launch_counter():
    """Kernel launches per task kind on this rank: wraps this process's
    registered executors (a rank process, once at its start) to read the
    two attention kernels' counters around each task."""
    from repro_torch.engine import tasks as tasks_mod
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    counts: Dict[str, Dict[str, int]] = {}
    for key, fn in list(tasks_mod._EXECUTORS.items()):
        def wrapped(st, bb, pl, _fn=fn, _kind=key[0].name):
            f0, d0 = fa.launches, dec.launches
            try:
                return _fn(st, bb, pl)
            finally:
                c = counts.setdefault(_kind, {"flash": 0, "decode": 0})
                c["flash"] += fa.launches - f0
                c["decode"] += dec.launches - d0
        tasks_mod._EXECUTORS[key] = wrapped
    return counts


def _gen_replay():
    """Hold each sharded GEN against a world-of-one GEN on the same
    weights: wraps this process's GEN executor (a rank process, once at
    its start) so that after the task every GEN rank gathers the weights
    it decoded with (a collective over the GEN mesh) and decodes the same
    prompts on them alone, from the generator state the task started
    from, through the same routing (``genserve.generate``: one wave or
    the engine).  The only difference left is the reduction order of the
    sharded matmuls.  Returns the list that receives each GEN's fraction
    of identical tokens (GEN ranks of a sharded placement only)."""
    from repro_torch.core.plan import decode_wave
    from repro_torch.core.workflow import TaskKind
    from repro_torch.engine import tasks as tasks_mod
    from repro_torch.genserve import adapter
    from repro_torch.parallel import sharding as sh
    agreement: List[float] = []
    key = (TaskKind.GEN, None)
    fn = tasks_mod._EXECUTORS[key]

    def wrapped(st, bb, pl):
        rng = bb["rng"]
        state = None if rng is None else rng.get_state()
        out = fn(st, bb, pl)
        if pl.sharded:
            with torch.no_grad():
                params = sh.full_tree(st.gen_params)
            prompts = bb["prompts_rep"]
            gen = None
            if state is not None:
                gen = torch.Generator(device=st.device)
                gen.set_state(state)
            with torch.inference_mode():
                ro, _ = adapter.generate(
                    params, st.cfg, prompts, gen, st.sampler,
                    wave=decode_wave(int(prompts.shape[0])),
                    decode_chunk=st.rl.decode_chunk,
                    prefill_chunk=st.rl.prefill_chunk, device=st.device)
            got = bb["fresh"]["rollout"]["gen_tokens"]
            agreement.append(float((ro["gen_tokens"] == got).float()
                                   .mean()))
        return out
    tasks_mod._EXECUTORS[key] = wrapped
    return agreement


def _summary(trainer, metrics, gens, walls) -> Dict[str, Any]:
    tokens, versions, synced, masks = gens
    eng = trainer.engine
    gen_t, train_t = eng.ctx.gen_task, eng.ctx.actor_train
    gen_pl, train_pl = eng.placements[gen_t], eng.placements[train_t]
    occ = eng.wave_occupancy_summary()
    cmp = eng.compare_with_simulator()
    return {
        "world": dist.world_size(),
        "gen_ranks": list(gen_pl.ranks), "train_ranks": list(train_pl.ranks),
        "gen_mesh": list(gen_pl.mesh_shape),
        "train_mesh": list(train_pl.mesh_shape),
        "folding_collisions": eng.ctx.folding.n_collisions,
        "overlap_active": eng.overlap_active(),
        "overlap_honest": occ.get("overlap_honest"),
        "staleness": [r.weight_version - r.gen_version
                      for r in eng.pipeline.records],
        "losses": [m.get("loss") for m in metrics],
        "rewards": [m.get("reward_mean") for m in metrics],
        "sync_gb": [m.get("sync_gb") for m in metrics],
        "tokens": tokens, "masks": masks, "gen_versions": versions,
        "wall_s": walls,
        "sync_identical": synced,
        "sync_s": list(eng.sync_durations),
        "measured_iter_s": cmp["measured_iter_s"],
        "predicted_iter_s": cmp["predicted_iter_s"],
        "predicted_iter_realized_s": cmp["predicted_iter_realized_s"],
        "tp_shrunk": cmp["tp_shrunk"],
        "actor_bytes": _actor_bytes(trainer),
        # GEN's engine per iteration: its wave and decode steps (the
        # single-wave path's wave is its whole batch)
        "gen_wave": [m.get("gen_wave") for m in metrics],
        "gen_decode_steps": [m.get("gen_decode_steps") for m in metrics],
        "gen_prefill_rounds": [m.get("gen_prefill_rounds", 0.0)
                               for m in metrics],
    }


def step_batch(B: int, S: int, gen_start: int, vocab: int,
               seed: int = 12) -> Dict[str, np.ndarray]:
    """A seeded PPO batch for one actor step (``actor_step``)."""
    rng = np.random.default_rng(seed)
    T = S - gen_start
    mask = np.ones((B, T), np.float32)
    for i, n in enumerate(rng.integers(1, T + 1, B)):
        mask[i, n:] = 0.0
    return {"sequences": rng.integers(0, vocab, (B, S)).astype(np.int64),
            "logp_old": (-rng.random((B, T)) * 3).astype(np.float32),
            "advantages": rng.normal(size=(B, T)).astype(np.float32),
            "mask": mask}


def actor_step(trainer, batch: Dict[str, np.ndarray], gen_start: int
               ) -> Optional[Dict[str, float]]:
    """One actor step on ``batch`` from the trainer's state, on the
    actor_training placement (sharded over its mesh) or on the one
    device; its loss and grad norm on the placement's ranks, None on
    the others."""
    eng = trainer.engine
    pl = eng.placements[eng.ctx.actor_train]
    if not pl.here:
        return None
    b = {k: torch.as_tensor(v, device=trainer.device)
         for k, v in batch.items()}
    if pl.sharded:
        b = pl.shard_batch(b)
        _, _, m = trainer.sharded_actor_step(pl, b)(
            trainer.actor, trainer.actor_opt, b, gen_start)
    else:
        _, _, m = trainer._actor_step(trainer.actor, trainer.actor_opt, b,
                                      gen_start)
    return {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"])}


def kernels_vs_plain(trainer, rows: int, prompt_len: int,
                     new_tokens: int, gen_rows: Optional[int] = None
                     ) -> Dict[str, Any]:
    """The two attention kernels as the sharded path calls them, at the
    path's shapes on this rank's placements (``mesh_attention``): GEN's
    prefill over the prompt and a decode step over the cache of prompt +
    new tokens at ``gen_rows`` rows (``rows`` when None; genserve's wave
    when GEN runs beyond one), INF's (reference_inference) pass over the
    whole sequence at ``rows``.  {label: (max abs error, the local q
    shape)} for the placements this rank is in (a placement of one rank
    calls the kernels on plain tensors); every rank of a placement calls
    it (the outputs are gathered)."""
    cfg, dev = trainer.cfg, trainer.device
    dims = (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim)
    named = {trainer.wf.task(t).name: pl
             for t, pl in trainer.engine.placements.items()}
    L = prompt_len + new_tokens
    out: Dict[str, Any] = {}
    pl = named["actor_generation"]
    if pl.here:
        got = mesh_attention(pl.mesh if pl.sharded else None, dev,
                             cfg.dtype, *dims, gen_rows or rows,
                             prompt_len, L)
        out["gen_prefill"], out["gen_decode"] = got["prefill"], \
            got["decode"]
    pl = named["reference_inference"]
    if pl.here:
        out["inf"] = mesh_attention(pl.mesh if pl.sharded else None, dev,
                                    cfg.dtype, *dims, rows, L)["prefill"]
    return out


def mesh_attention(mesh, dev, dtype: str, H: int, KV: int, hd: int,
                   rows: int, S: int, L: Optional[int] = None,
                   seed: int = 11) -> Dict[str, Any]:
    """``multihead_attention`` on DTensors as a sharded step calls it
    (each rank of ``mesh`` launches the kernel on its local rows, over
    ``data``, and heads, over ``model``; heads that ``model`` does not
    divide stay whole and the rows split over it too,
    ``sharding.head_specs``): a causal pass over ``S`` positions
    ("prefill", the flash kernel) and, with ``L``, one decode step
    against an ``L``-slot cache whose last slot is not yet valid
    ("decode", the flash-decode kernel); seeded inputs in ``dtype``,
    held against the plain versions on the full tensors.  {label: (max
    abs error, the q shape the kernel takes on this rank)}; every rank
    of the mesh calls it.  With ``mesh`` None, the same calls on plain
    tensors (a placement of one rank)."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.models import attention
    from repro_torch.parallel import sharding as sh
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(seed)

    def rn(*shape):
        return torch.randn(shape, generator=g).to(dev, dt)

    def local(x):
        if mesh is None:
            return list(x.shape)
        b, m = sh.head_specs(mesh, rows, math.gcd(H, KV))
        return list(sh.local_block(torch.empty(x.shape, device="meta"),
                                   mesh, sh.placements(sh.P(b, None, m),
                                                       mesh)).shape)

    def full(x):
        return x.full_tensor() if mesh is not None else x

    heads = sh.P("data", None, "model", None)

    def place(ts):
        return [sh.distribute(t, mesh, heads) for t in ts] \
            if mesh is not None else list(ts)
    q, k, v = rn(rows, S, H, hd), rn(rows, S, KV, hd), rn(rows, S, KV, hd)
    pos = torch.arange(S, device=dev)
    d = place((q, k, v))
    got = attention.multihead_attention(*d, pos, pos, causal=True,
                                        force_impl="kernel")
    want = fa.flash_attention_plain(q, k, v, causal=True)
    out = {"prefill": (float((full(got) - want).abs().max()),
                       local(d[0]))}
    if L is None:
        return out
    q, kc, vc = rn(rows, 1, H, hd), rn(rows, L, KV, hd), rn(rows, L, KV, hd)
    valid = L - 1                          # the cache before the last token
    bias = torch.where(torch.arange(L, device=dev) < valid, 0.0,
                       -1e30).expand(rows, L).contiguous()
    d = place((q, kc, vc))
    pos = torch.arange(L, device=dev)
    got = attention.multihead_attention(
        *d, pos[valid - 1:valid], pos, causal=True, bias=bias,
        force_impl="kernel")
    want = dec.decode_attention_plain(q[:, 0], kc, vc, bias)
    out["decode"] = (float((full(got)[:, 0] - want).abs().max()),
                     local(d[0])[:1] + local(d[0])[2:])
    return out


def _actor_bytes(trainer) -> int:
    from repro_torch.rl.sync import tree_bytes
    return tree_bytes(trainer.meta["actor"])


def rank_main(device, cfg: ModelConfig, iters: int, batch: int,
              modes=("sampled", "greedy"), state: Optional[dict] = None,
              count_launches: bool = False, n_rollouts: int = 4,
              max_new_tokens: int = 4,
              step: Optional[tuple] = None,
              kernels: bool = False,
              variants: Optional[Dict[str, dict]] = None,
              evaluate: bool = False, replay: bool = False
              ) -> Dict[str, Any]:
    """One rank's run: for each of ``modes`` a fresh trainer over
    ``iters`` iterations: "sampled", "greedy", or "serialized" (sampled,
    with the overlapped walk off: the stage walk of the same world); then
    each of ``variants`` (label -> ``make_trainer`` keywords, e.g.
    ``{"chunked": {"greedy": True, "prefill_chunk": 16}}``).  ``state``
    (a numpy state tree, the JAX package's ``state_tree()``) replaces
    the seeded weights.  With ``step`` = (a ``step_batch``, its
    gen_start), first one ``actor_step`` on it from a fresh trainer's
    state; with ``kernels``, ``kernels_vs_plain`` at the runs' shapes
    (these launches are outside the task counts); with ``evaluate``,
    each run's trainer then scores a fixed prompt batch
    (``RLTrainer.evaluate``); with ``replay``, each run's GEN tasks are
    held against a world-of-one GEN on the same weights (``_gen_replay``:
    a summary's ``replay_agreement``, on the GEN ranks).  Returns this
    rank's summaries (and launches per task kind, and the peak device
    memory, on the card)."""
    from repro_torch.core.plan import decode_wave
    counts = _launch_counter() if count_launches else None
    replayed = _gen_replay() if replay else None
    out: Dict[str, Any] = {"rank": dist.rank()}
    rows = batch * n_rollouts
    if step is not None or kernels:
        tr = make_trainer(cfg, device, n_rollouts=n_rollouts,
                          max_new_tokens=max_new_tokens)
        if step is not None:
            out["step"] = actor_step(tr, *step)
        if kernels:
            out["kernels"] = kernels_vs_plain(
                tr, rows, tr.task.prompt_len, max_new_tokens,
                gen_rows=decode_wave(rows))
        del tr
    runs = [(m, dict(greedy=m == "greedy",
                     overlap=False if m == "serialized" else None))
            for m in modes] + list((variants or {}).items())
    for label, kw in runs:
        tr = make_trainer(cfg, device, n_rollouts=n_rollouts,
                          max_new_tokens=max_new_tokens, **kw)
        if state is not None:
            from repro_torch import bridge
            tr.load_state_tree(bridge.from_numpy_state_tree(
                state, cfg, tr.device))
        out[label] = _summary(tr, *run(tr, iters, batch))
        if replayed is not None:
            out[label]["replay_agreement"] = list(replayed)
            replayed.clear()
        if evaluate:
            out[label]["eval"] = evaluate_batch(tr)
        del tr
    if counts is not None:
        out["launches"] = counts
    if torch.device(device).type == "cuda":
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def evaluate_batch(trainer, n: int = 8, seed: int = 3) -> float:
    """``RLTrainer.evaluate`` on a fixed prompt batch (every rank calls
    it; every rank gets the GEN lead's score)."""
    prompts, answers = trainer.task.sample_batch(
        np.random.default_rng(seed), n)
    return trainer.evaluate(prompts, answers, None)


def check(sharded: Dict[str, Any], base: Dict[str, Any], *,
          greedy: bool, loss_rtol: float = 5e-2,
          loss_atol: float = 1e-4) -> None:
    """The example's assertions on the 8-rank summary (rank 0's) against
    the world-1 one, for one mode (tokens as the module docstring
    says)."""
    assert sharded["folding_collisions"] == 0
    assert set(sharded["gen_ranks"]).isdisjoint(sharded["train_ranks"])
    assert sharded["train_mesh"] == [2, 2], sharded["train_mesh"]
    assert sharded["gen_mesh"] == [2, 2], sharded["gen_mesh"]
    assert sharded["overlap_active"] is True
    assert sharded["overlap_honest"] == 1.0
    assert base["overlap_active"] is False
    assert all(s == 1 for s in sharded["staleness"][1:]), \
        sharded["staleness"]
    for it, (a, b) in enumerate(zip(sharded["tokens"], base["tokens"])):
        assert a is not None and b is not None
        if greedy or sharded["gen_versions"][it] == 0:
            assert np.array_equal(a, b), \
                f"iter {it}: generation diverged between worlds"
            assert np.array_equal(sharded["masks"][it], base["masks"][it]), \
                f"iter {it}: gen masks differ between worlds"
        else:
            assert float(np.mean(a == b)) >= AGREEMENT, \
                f"iter {it}: {int(np.sum(a != b))} of {a.size} tokens differ"
    ls, lb = sharded["losses"][1:], base["losses"][1:]
    np.testing.assert_allclose(ls, lb, rtol=loss_rtol, atol=loss_atol)
    np.testing.assert_allclose(sharded["rewards"][1:], base["rewards"][1:],
                               rtol=1e-6)
    nbytes = sharded["actor_bytes"]
    assert all(abs(g * 1e9 - nbytes) < 1 for g in sharded["sync_gb"][1:])
    for a in sharded.get("replay_agreement", ()):
        assert a >= REPLAY_AGREEMENT, \
            f"GEN vs a world-of-one GEN on its own weights: {a}"
    assert all(x is True for x in sharded["sync_identical"]), \
        f"GEN weights differ from the actor after a sync: " \
        f"{sharded['sync_identical']}"


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--loss-rtol", type=float, default=5e-2)
    ap.add_argument("--loss-atol", type=float, default=1e-4)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--json", action="store_true",
                    help="emit a machine-readable summary on stdout")
    args = ap.parse_args(argv)
    cfg = tiny_cfg()
    res = dist.spawn(rank_main, WORLD, args.device, cfg, args.iters,
                     args.batch, timeout=args.timeout)
    device = torch.device(args.device)
    base = {m: _summary(tr, *run(tr, args.iters, args.batch))
            for m, tr in ((m, make_trainer(cfg, device,
                                           greedy=m == "greedy"))
                          for m in ("sampled", "greedy"))}
    sharded = res[0]
    for mode in ("sampled", "greedy"):
        check(sharded[mode], base[mode], greedy=mode == "greedy",
              loss_rtol=args.loss_rtol, loss_atol=args.loss_atol)
    assert any(abs(x) > 1e-6 for x in sharded["sampled"]["losses"][1:]), \
        "degenerate run: every loss is zero, parity would be vacuous"
    s = sharded["sampled"]
    summary = {k: v for k, v in s.items() if k != "tokens"}
    summary.update(loss_baseline=base["sampled"]["losses"],
                   greedy_tokens_identical=True)
    if args.json:
        print(json.dumps(summary))
    else:
        print(f"world {WORLD}: gen on ranks {s['gen_ranks']}, train on "
              f"{s['train_ranks']} (mesh {s['train_mesh']}, collisions "
              f"{s['folding_collisions']}, overlap {s['overlap_active']})")
        for it, (a, b) in enumerate(zip(s["losses"][1:],
                                        base["sampled"]["losses"][1:]), 1):
            print(f"iter {it}: loss sharded={a:+.6f} world-1={b:+.6f} "
                  f"delta={a - b:+.2e}")
        print("greedy generation token-identical; sampled identical before "
              f"the first sync, >= {AGREEMENT:.0%} after it")
        print("sharded execution parity OK")
    return summary


if __name__ == "__main__":
    main()
