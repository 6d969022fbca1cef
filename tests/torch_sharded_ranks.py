"""Rank functions of the sharded CPU tests (``test_torch_sharded.py``,
``test_torch_sharded_exec.py``, ``test_torch_sharded_genserve.py``,
``test_torch_moe_mesh.py``) and the subprocess that spawns them.

The tests run ``python tests/torch_sharded_ranks.py IN OUT`` with a
timeout of their own: ``IN`` is a pickle of the job (its kind and
inputs, numpy only), ``OUT`` receives rank 0's results.  The ranks are
gloo processes on the CPU (``parallel.dist.spawn``: one intra-op thread
each, FileStore rendezvous), so parallel test workers never share a
port.  Imports the port only: no JAX.
"""
import dataclasses
import os
import pickle
import sys

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import enumerate as enum_mod, topology, workflow
from repro_torch.data.synthetic import AdditionTask
from repro_torch.engine import tasks as tasks_mod
from repro_torch.models.config import ModelConfig
from repro_torch.parallel import dist
from repro_torch.parallel import sharding as sh
from repro_torch.rl.trainer import RLConfig, RLTrainer
from repro_torch.tree import tree_map


def _np(tree):
    return tree_map(lambda x: x.detach().cpu().numpy()
                    if torch.is_tensor(x) else x, tree)


def mesh_plan(wf, n: int = 4, dp: int = 2, tp: int = 2):
    """Every task on all ``n`` plan devices at (dp, 1, tp): one mesh."""
    topo = topology.build_testbed("single_region", counts={"A100": n})
    grouping = (tuple(range(wf.n_tasks)),)
    plan = enum_mod.build_plan(topo, wf, grouping, [n], list(range(n)),
                               parallel={t: (dp, 1, tp)
                                         for t in range(wf.n_tasks)})
    return topo, plan


def steps_trainer(cfg: ModelConfig, rl: RLConfig, state, device, plan_fn):
    task = AdditionTask(max_operand=9)
    wf = workflow.make_workflow(
        rl.algorithm, workflow.LLMSpec.from_model_config(cfg),
        synchronous=True, n_rollouts=rl.n_rollouts, seq_in=task.prompt_len,
        seq_out=rl.max_new_tokens, global_batch=1)
    topo, plan = plan_fn(wf)
    tr = RLTrainer(cfg, rl, task, seed=0, plan=plan, topo=topo, wf=wf,
                   device=device)
    tr.load_state_tree(bridge.from_numpy_state_tree(state, cfg, device))
    return tr


def _placement(tr, name):
    return next(pl for t, pl in tr.engine.placements.items()
                if tr.wf.task(t).name == name)


def steps_rank(device, job):
    """The trainer's five sharded steps on one 2x2 mesh, from the job's
    state and batch; the results full (collectives on every rank)."""
    cfg, G = job["cfg"], job["gen_start"]
    tr = steps_trainer(cfg, job["rl"], job["state"], device, mesh_plan)
    out = {"mesh": {}}
    batch = {k: torch.as_tensor(v) for k, v in job["batch"].items()}
    batch["sequences"] = batch["sequences"].long()

    pl = _placement(tr, "actor_training")
    out["mesh"]["actor_training"] = (pl.mesh_shape, pl.ranks)
    ab = pl.shard_batch({k: batch[k] for k in
                         ("sequences", "logp_old", "advantages", "mask")})
    p, opt, m = tr.sharded_actor_step(pl, ab)(tr.actor, tr.actor_opt, ab, G)
    out["actor"] = _np(sh.full_tree(p))
    out["actor_opt"] = _np(sh.full_tree(opt))
    out["actor_metrics"] = {k: float(v) for k, v in m.items()}
    out["actor_placements"] = str(tr.actor["blocks"]["layer0"]["attn"]
                                  ["wq"].placements)
    out["step_replicated"] = tuple(opt["step"].placements) == \
        pl.replicated_sharding()
    out["batch_placements"] = str(pl.batch_shardings(ab)["mask"])

    cpl = _placement(tr, "critic_training")
    cb = cpl.shard_batch(batch)
    (c, h), copt, closs = tr.sharded_critic_step(cpl, cb)(
        (tr.critic, tr.value_head), tr.critic_opt, cb, G)
    out["critic"] = _np(sh.full_tree(c))
    out["value_head"] = _np(sh.full_tree(h))
    out["critic_loss"] = float(closs)

    seqs = batch["sequences"]
    rpl = _placement(tr, "reference_inference")
    sd = rpl.shard_batch(seqs)
    out["ref_logp"] = _np(tr.sharded_ref_logp(rpl, sd)(tr.ref, sd, G))
    ipl = _placement(tr, "critic_inference")
    sd = ipl.shard_batch(seqs)
    out["values"] = _np(tr.sharded_critic_vals(ipl, sd)(
        tr.critic, tr.value_head, sd, G))

    gpl = _placement(tr, "actor_generation")
    prompts = torch.as_tensor(job["prompts"]).long()
    pd = gpl.shard_batch(prompts)
    out["rollout"] = _np(tr.sharded_generate(gpl, pd)(tr.gen_params, pd,
                                                      None))
    out["kernels"] = kernels_on_dtensors(gpl.mesh)
    # the same GEN on the genserve engine, served on the GEN mesh
    tr.rl = dataclasses.replace(tr.rl, gen_engine="genserve")
    bb = {"prompts_rep": prompts, "rng": None, "gen_start": G,
          "answers_rep": np.zeros(len(prompts))}
    tasks_mod.run_generation(tr, bb, gpl)
    out["genserve_rollout"] = _np(bb["fresh"]["rollout"])
    out["genserve_engine"] = bb["gen_stats"]["engine"]
    return out


def kernels_on_dtensors(mesh, device=torch.device("cpu")):
    """The four kernel wrappers on DTensor inputs (each rank on its
    local rows and heads or channels; on the CPU their plain versions)
    against the plain versions on the full inputs: max abs error and the
    output placements, per kernel."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as mb
    from repro_torch.kernels.rwkv6_scan import ops as rw
    g = torch.Generator().manual_seed(5)

    def rn(*shape):
        return torch.randn(shape, generator=g).to(device)

    def rand(*shape):
        return torch.rand(shape, generator=g).to(device)
    P = sh.P
    out = {}
    q, k, v = rn(4, 6, 4, 32), rn(4, 6, 2, 32), rn(4, 6, 2, 32)
    heads = P("data", None, "model", None)
    got = fa.flash_attention(*(sh.distribute(t, mesh, heads)
                               for t in (q, k, v)), window=4, cap=30.0)
    want = fa.flash_attention_plain(q, k, v, window=4, cap=30.0)
    out["flash_attention"] = (float((got.full_tensor() - want).abs().max()),
                              str(got.placements))
    q1, kc, vc = rn(4, 4, 32), rn(4, 10, 2, 32), rn(4, 10, 2, 32)
    bias = torch.where(torch.arange(10, device=device) < 7, 0.0,
                       -1e30).expand(4, 10)
    got = dec.decode_attention(sh.distribute(q1, mesh, P("data", "model")),
                               sh.distribute(kc, mesh, heads),
                               sh.distribute(vc, mesh, heads), bias)
    want = dec.decode_attention_plain(q1, kc, vc, bias)
    out["decode_attention"] = (float((got.full_tensor() - want).abs().max()),
                               str(got.placements))
    # head and state sizes the CUDA kernels are instantiated for
    r, kk, vv = rn(4, 5, 4, 32), rn(4, 5, 4, 32), rn(4, 5, 4, 32)
    logw, u = -rand(4, 5, 4, 32), rn(4, 32)
    got = rw.rwkv6_scan(*(sh.distribute(t, mesh, heads)
                          for t in (r, kk, vv, logw)), u)
    want = rw.rwkv6_scan_plain(r, kk, vv, logw, u)
    out["rwkv6_scan"] = (max(float((a.full_tensor() - b).abs().max())
                             for a, b in zip(got, want)),
                         str(got[0].placements))
    dt, x = rand(4, 5, 8), rn(4, 5, 8)
    Bm, Cm, A = rn(4, 5, 8), rn(4, 5, 8), -rand(8, 8)
    chan = P("data", None, "model")
    got = mb.mamba_scan(sh.distribute(dt, mesh, chan),
                        sh.distribute(x, mesh, chan), Bm, Cm, A)
    want = mb.mamba_scan_plain(dt, x, Bm, Cm, A)
    out["mamba_scan"] = (max(float((a.full_tensor() - b).abs().max())
                             for a, b in zip(got, want)),
                         str(got[0].placements))
    return out


def kernels_rank(device):
    """``kernels_on_dtensors`` on a 2x2 mesh of this world's ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh(device.type, torch.arange(4).reshape(2, 2),
                      mesh_dim_names=sh.AXES)
    return kernels_on_dtensors(mesh, device)


def exec_rank(device, job):
    from repro_torch.launch import sharded_exec
    return sharded_exec.rank_main(device, job["cfg"], job["iters"],
                                  job["batch"], modes=job["modes"],
                                  state=job["state"], kernels=True,
                                  replay=True)


def exec_world1(job):
    """The same runs folded onto one device (this process, no world)."""
    from repro_torch.launch import sharded_exec
    out = {}
    for mode in job["modes"]:
        tr = sharded_exec.make_trainer(job["cfg"], torch.device("cpu"),
                                       greedy=mode == "greedy")
        tr.load_state_tree(bridge.from_numpy_state_tree(
            job["state"], job["cfg"], tr.device))
        out[mode] = sharded_exec._summary(
            tr, *sharded_exec.run(tr, job["iters"], job["batch"]))
    return out


def swap_run(device, job):
    """Two iterations on the gen | rest plan, a swap to every task on all
    8 plan devices at (4, 1, 2), two more: losses, the placements after
    the swap, the overlap switch and the epoch."""
    from repro_torch.launch import sharded_exec
    tr = sharded_exec.make_trainer(job["cfg"], device)
    m1, g1, _ = sharded_exec.run(tr, 2, job["batch"])
    before = {tr.wf.task(t).name: list(pl.ranks)
              for t, pl in tr.engine.placements.items()}
    topo, plan = mesh_plan(tr.wf, n=8, dp=4, tp=2)
    info = tr.engine.apply_plan(plan, topo=topo)
    m2, g2, _ = sharded_exec.run(tr, 2, job["batch"], seed=1)
    return {"losses": [m["loss"] for m in m1 + m2],
            "before": before,
            "after": {tr.wf.task(t).name: (list(pl.mesh_shape),
                                           list(pl.ranks))
                      for t, pl in tr.engine.placements.items()},
            "overlap": tr.engine.overlap_active(), "epoch": info["epoch"],
            "sync_identical": g1[2] + g2[2],
            "staleness": [r.weight_version - r.gen_version
                          for r in tr.engine.pipeline.records]}


# ---------------------------------------------------------------------------
# genserve on a mesh (test_torch_sharded_genserve.py)
# ---------------------------------------------------------------------------

def _gather_spy():
    """Record the local shape of every all-gather input (DTensor's
    functional all-gathers, by either name, and the plain collective):
    [shapes], undo."""
    import torch.distributed as tdist
    import torch.distributed._functional_collectives as funcol
    shapes, saved = [], []
    for mod, name, arg in ((funcol, "all_gather_tensor", 0),
                           (funcol, "all_gather_single", 0),
                           (tdist, "all_gather_into_tensor", 1)):
        fn = getattr(mod, name, None)
        if fn is None:
            continue
        saved.append((mod, name, fn))

        def spy(*a, _fn=fn, _arg=arg, **k):
            shapes.append(tuple(a[_arg].shape))
            return _fn(*a, **k)
        setattr(mod, name, spy)

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return shapes, undo


def serve_modes(device, job, mesh=None):
    """Each mode of the job through ``genserve.generate`` (on ``mesh``
    when given): the rollout, the engine stats the tests compare, the
    leaked pages, the wall seconds, and on a mesh the cache leaves'
    placements after serving and whether any all-gather took a cache
    shard's shape."""
    import time
    from repro_torch.genserve import adapter, decoder
    from repro_torch.rl.rollout import SamplerConfig
    params = {a: bridge.from_numpy_params(p, job["cfgs"][a], device)
              for a, p in job["params"].items()}
    dcfg = job.get("draft_cfg")
    draft = None if dcfg is None else bridge.from_numpy_params(
        job["draft"], dcfg, device)
    out = {}
    init_state = decoder._init_state
    for name, m in job["modes"].items():
        cfg = job["cfgs"][m["arch"]]
        kw = dict(m["kw"])
        if kw.get("spec_k"):
            kw.update(draft_params=draft, draft_cfg=dcfg)
        states = []

        def capture(*a, **k):
            states.append(init_state(*a, **k))
            return states[-1]
        decoder._init_state = capture
        shapes, undo = _gather_spy() if mesh is not None else ([], None)
        t0 = time.monotonic()
        try:
            ro, st = adapter.generate(
                params[m["arch"]], cfg, torch.as_tensor(m["prompts"]), None,
                SamplerConfig(max_new_tokens=m["N"], greedy=True,
                              eos_token=m.get("eos")),
                fast_path=False, device=device, mesh=mesh, **kw)
        finally:
            decoder._init_state = init_state
            if undo is not None:
                undo()
        rec = {"rollout": _np(ro), "wall": time.monotonic() - t0,
               "stats": {k: v for k, v in st.items()
                         if not k.startswith("_")
                         and k not in ("ttft", "queue_wait", "rounds")}}
        if "_pagepool" in st:
            rec["leaked"] = st["_pagepool"].leak_check(
                expected_refs=st["_radix"].page_refs())
        if mesh is not None:
            caches = {k: states[0][k] for k in ("cache", "dcache")
                      if k in states[0]}
            rec["placements"] = {
                f"{k}/{layer}/{leaf}": (sh.is_dtensor(t), str(t.placements)
                                        if sh.is_dtensor(t) else None)
                for k, blocks in caches.items()
                for layer, leaves in blocks.items()
                for leaf, t in leaves.items()}
            # a leaf's local shape, and a k/v entry's (one repeat): the
            # 2-D entries of the recurrent leaves would meet the logits'
            local = {tuple(t.to_local().shape[i:])
                     for blocks in caches.values()
                     for leaves in blocks.values()
                     for leaf, t in leaves.items()
                     for i in ((0, 1) if leaf in ("k", "v") else (0,))}
            rec["cache_gathered"] = sorted(set(shapes) & local)
            rec["n_gathers"] = len(shapes)
        out[name] = rec
    return out


def genserve_rank(device, job):
    """``serve_modes`` on a 2x2 ("data", "model") mesh of this world."""
    from torch.distributed.device_mesh import DeviceMesh
    mesh = DeviceMesh(device.type, torch.arange(4).reshape(2, 2),
                      mesh_dim_names=sh.AXES)
    return serve_modes(device, job, mesh)


def gen_rl_rank(device, job):
    from repro_torch.launch import sharded_exec
    return sharded_exec.rank_main(
        device, job["cfg"], job["iters"], job["batch"], modes=(),
        state=job["state"], n_rollouts=job["n_rollouts"],
        variants=job["variants"], evaluate=True)


def gen_rl_world1(job):
    """The variants folded onto one device (this process, no world)."""
    from repro_torch.launch import sharded_exec
    out = {}
    for label, kw in job["variants"].items():
        tr = sharded_exec.make_trainer(job["cfg"], torch.device("cpu"),
                                       n_rollouts=job["n_rollouts"], **kw)
        if job["state"] is not None:
            tr.load_state_tree(bridge.from_numpy_state_tree(
                job["state"], job["cfg"], tr.device))
        out[label] = sharded_exec._summary(
            tr, *sharded_exec.run(tr, job["iters"], job["batch"]))
        out[label]["eval"] = sharded_exec.evaluate_batch(tr)
    return out


# ---------------------------------------------------------------------------
# MoE models and heads that ``model`` does not divide (test_torch_moe_mesh.py)
# ---------------------------------------------------------------------------

def _kernel_spy():
    """Record the shape of the main operand each kernel wrapper's plain
    version takes (on the CPU, where a wrapper would launch its kernel):
    {kernel: [shapes]}, undo."""
    from repro_torch.kernels.decode_attention import ops as dec
    from repro_torch.kernels.flash_attention import ops as fa
    from repro_torch.kernels.mamba_scan import ops as mb
    from repro_torch.kernels.rwkv6_scan import ops as rw
    seen, saved = {}, []
    for name, mod, attr, arg in (
            ("flash_attention", fa, "flash_attention_plain", 0),
            ("decode_attention", dec, "decode_attention_plain", 0),
            ("mamba_scan", mb, "mamba_scan_plain", 1),
            ("rwkv6_scan", rw, "rwkv6_scan_plain", 0)):
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))

        def spy(*a, _fn=fn, _name=name, _arg=arg, **k):
            seen.setdefault(_name, []).append(tuple(a[_arg].shape))
            return _fn(*a, **k)
        setattr(mod, attr, spy)

    def undo():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return seen, undo


def train_steps(device, job, mesh=None):
    """``launch.steps``' LM train step (remat on, fp32 Adam) for each of
    the job's ``train`` configs, from the job's weights and batch; on
    ``mesh`` as DTensors laid out by the step's sharding trees, under
    its activation rules: the loss, the stepped parameters and Adam's
    first moments, full."""
    from repro_torch.configs.shapes import InputShape
    from repro_torch.launch import steps
    from repro_torch.optim import adam
    out = {}
    for name in job["train"]:
        cfg = job["cfgs"][name]
        params = bridge.from_numpy_params(job["params"][name], cfg, device)
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in job["train_batch"].items()}
        B, S = batch["tokens"].shape
        shape = InputShape("smoke", S, B, "train")
        opt_cfg = adam.AdamConfig()
        opt = adam.init_adam_state(params, opt_cfg)
        step = steps.make_train_step(cfg, opt_cfg, remat=True)
        if mesh is None:
            p, o, m = step(params, opt, batch)
        else:
            from torch.distributed.tensor.experimental import \
                implicit_replication
            params = steps.distribute_tree(
                params, mesh, steps.param_shardings(mesh, params))
            opt = steps.distribute_tree(
                opt, mesh, steps.opt_shardings(mesh, params))
            batch = steps.distribute_tree(
                batch, mesh, steps.batch_shardings(mesh, batch, shape))
            with sh.use_hints(steps.activation_rules(mesh, shape)), \
                    implicit_replication():
                p, o, m = step(params, opt, batch)
            p, o = sh.full_tree(p), sh.full_tree(o)
        out[name] = {"loss": float(sh.full(m["loss"])), "params": _np(p),
                     "m": _np(o["m"])}
    return out


def moe_mesh_run(device, job, meshes=None):
    """``serve_modes`` with the kernel wrappers spied on (each config on
    the mesh of its shape in ``job["mesh_shapes"]``, 2x2 by default;
    ``meshes``: shape -> mesh, None for the world of one), then
    ``train_steps`` on the 2x2 mesh."""
    shapes = job.get("mesh_shapes", {})
    served, seen = {}, {}
    for shape in sorted({tuple(shapes.get(m["arch"], (2, 2)))
                         for m in job["modes"].values()}):
        sub = {k: m for k, m in job["modes"].items()
               if tuple(shapes.get(m["arch"], (2, 2))) == shape}
        spied, undo = _kernel_spy()
        try:
            served.update(serve_modes(device, {**job, "modes": sub},
                                      None if meshes is None
                                      else meshes[shape]))
        finally:
            undo()
        for k, v in spied.items():
            seen.setdefault(str(shape), {})[k] = v
    return {"served": served, "kernels": seen,
            "train": train_steps(device, job, None if meshes is None
                                 else meshes[(2, 2)])}


def moe_mesh_rank(device, job):
    """``moe_mesh_run`` on ("data", "model") meshes of this world's 4
    ranks: 2x2 and 1x4."""
    from torch.distributed.device_mesh import DeviceMesh
    return moe_mesh_run(device, job, {
        shape: DeviceMesh(device.type, torch.arange(4).reshape(shape),
                          mesh_dim_names=sh.AXES)
        for shape in ((2, 2), (1, 4))})


# ---------------------------------------------------------------------------
# the RL launcher's drift and faults on ranks (test_torch_elastic_ranks.py,
# test_torch_faults_ranks.py)
# ---------------------------------------------------------------------------

def plan_key(plan):
    """A plan's parallelization and device assignment, comparable."""
    return (sorted((int(t), tuple(int(x) for x in p))
                   for t, p in plan.parallel.items()),
            sorted((int(t), np.asarray(a).tolist())
                   for t, a in plan.assignment.items()))


def records(controller):
    """The elastic controller's reactions, comparable across worlds."""
    if controller is None:
        return []
    return [{"iteration": r.iteration, "epoch": r.epoch,
             "applied": r.applied, "forced": r.forced,
             "reactive": r.reactive, "plan": plan_key(r.decision.plan),
             "ckpt_bytes": r.ckpt_bytes} for r in controller.records]


def placed(trainer):
    """task name -> its placement's ranks."""
    return {trainer.wf.task(t).name: list(pl.ranks)
            for t, pl in trainer.engine.placements.items()}


def launch_runs(runs, root):
    """``launch.train.main`` on this rank for each (name, argv) of
    ``runs`` in turn, each in a working directory of its own under
    ``root`` (the checkpoints' ``results/elastic_ckpt``) with fresh
    metrics: the lines this rank printed, its outcome ("done" or the
    exception it raised), the controller's records, and the launcher's
    result (the trainer is the last run's, for the caller)."""
    import contextlib
    import io
    from repro_torch.launch import train
    from repro_torch.obs import metrics
    out = {}
    for name, argv in runs:
        cwd = os.path.join(root, name)
        os.makedirs(cwd, exist_ok=True)
        os.chdir(cwd)
        metrics.reset()
        buf = io.StringIO()
        res, outcome = None, "done"
        try:
            with contextlib.redirect_stdout(buf):
                res = train.main(list(argv))
        except Exception as e:          # the same on every rank, or not
            outcome = f"{type(e).__name__}: {e}"
        out[name] = {"lines": buf.getvalue().splitlines(),
                     "outcome": outcome,
                     "records": records(res["controller"]) if res else [],
                     "holds": None if res is None else sorted(
                         k for k in res["trainer"].meta
                         if getattr(res["trainer"], k) is not None),
                     "result": res}
    return out


def _gen_tokens(trainer):
    """Record the gen tokens of every fresh bundle the engine pushes
    (every rank pushes the exchanged bundle)."""
    tokens = []
    pipe = trainer.engine.pipeline
    push = pipe.push

    def spy(fresh):
        tokens.append(fresh["rollout"]["gen_tokens"].cpu().numpy())
        return push(fresh)
    pipe.push = spy
    return tokens


def ckpt_roundtrip(trainer, controller, iteration: int, batch: int):
    """After a launcher run: a checkpoint through the controller (rank 0
    writes the state gathered from the ranks), the gathered state, then
    two greedy iterations, the checkpoint restored on every rank, and
    the same two iterations again: their tokens, the state gathered
    after the restore, and which state keys this rank holds."""
    path, nbytes = controller.checkpoint_now(iteration)
    state = _np(trainer.gather_state_tree())
    trainer.sampler = dataclasses.replace(trainer.sampler, greedy=True)
    tokens = _gen_tokens(trainer)

    def two():
        rng = np.random.default_rng(5)
        for _ in range(2):
            prompts, answers = trainer.task.sample_batch(rng, batch)
            trainer.iteration(prompts, answers, None)
    two()
    trainer.restore_checkpoint(path)
    restored = _np(trainer.gather_state_tree())
    two()
    return {"path": path, "bytes": nbytes, "state": state,
            "restored": restored, "tokens": tokens,
            "holds": sorted(k for k in trainer.meta
                            if getattr(trainer, k) is not None)}


def gen_swap(device, job):
    """``sharded_exec``'s greedy trainer (async GRPO, GEN on plan devices
    0-3): two iterations, then a forced replan that drops GEN's last
    plan device (``ElasticController.handle_failure``), then two more:
    the GEN tokens of each iteration, GEN's ranks and mesh before and
    after, and the plan decided on.  The same in a world of one."""
    from repro_torch.engine.elastic import ElasticConfig, ElasticController
    from repro_torch.engine.executor import TaskExecutionError
    from repro_torch.launch import sharded_exec as sx
    tr = sx.make_trainer(job["cfg"], device, greedy=True)
    eng = tr.engine
    gen_t = eng.ctx.gen_task

    def where():
        pl = eng.placements[gen_t]
        return list(pl.ranks), list(pl.mesh_shape)
    _, g1, _ = sx.run(tr, 2, job["batch"])
    before = where()
    devs = [int(d) for d in eng.plan.assignment[gen_t].reshape(-1)]
    err = TaskExecutionError(gen_t, "actor_generation", devs, 1,
                             RuntimeError("GEN worker lost"),
                             permanent=True, dead_devices=(max(devs),))
    ctrl = ElasticController(tr, lambda it: eng.topo,
                             ElasticConfig(budget=job["budget"]))
    rec = ctrl.handle_failure(2, err)
    _, g2, _ = sx.run(tr, 2, job["batch"], seed=1)
    return {"tokens": g1[0] + g2[0], "before": before, "after": where(),
            "plan": plan_key(rec.decision.plan), "epoch": rec.epoch,
            "placed": placed(tr)}


def overlapped_failure(device, job):
    """``sharded_exec``'s trainer (async GRPO: on ranks GEN decodes on
    0-3 while 4-7 train, the overlapped walk) with a permanent crash of
    actor_training at iteration 1, its first trained one: the error this
    rank raised; then the forced replan drops the dead device, one more
    iteration runs, and: the placements, whether this rank runs any
    task, the state keys it holds, the injector's log.  The same in a
    world of one (the stage walk)."""
    from repro_torch.core import retry
    from repro_torch.engine.elastic import ElasticConfig, ElasticController
    from repro_torch.engine.executor import TaskExecutionError
    from repro_torch.faults import FaultInjector, fault_scenario
    from repro_torch.launch import sharded_exec as sx
    tr = sx.make_trainer(job["cfg"], device, greedy=True)
    eng = tr.engine
    inj = FaultInjector(fault_scenario(
        "permanent_crash", at=1, gen_task=eng.ctx.gen_task,
        train_task=eng.ctx.actor_train, n_tasks=tr.wf.n_tasks))
    eng.attach_fault_injector(inj)
    eng.set_task_retry(retry.RetryPolicy(max_attempts=3),
                       sleep=lambda s: None)
    out = {"overlap": eng.overlap_active(), "error": None}
    rng = np.random.default_rng(0)
    gen = torch.Generator(device=tr.device).manual_seed(7)
    for it in range(2):
        prompts, answers = tr.task.sample_batch(rng, job["batch"])
        try:
            tr.iteration(prompts, answers, gen)
        except TaskExecutionError as e:
            out["error"] = {"text": str(e), "task": e.task,
                            "permanent": e.permanent,
                            "dead": list(e.dead_devices),
                            "devices": list(e.devices)}
            ctrl = ElasticController(tr, lambda i: eng.topo,
                                     ElasticConfig(budget=job["budget"]))
            rec = ctrl.handle_failure(it, e)
            out["plan"] = plan_key(rec.decision.plan)
            m = tr.iteration(prompts, answers, gen)
            out["after_loss"] = m.get("loss")
    # a swap that keeps every placement where it is: the sharded states
    # redistribute on their meshes, which a rank outside them skips
    eng.apply_plan(eng.plan, topo=eng.topo)
    prompts, answers = tr.task.sample_batch(rng, job["batch"])
    out["kept_loss"] = tr.iteration(prompts, answers, gen).get("loss")
    out["placed"] = placed(tr)
    out["runs_a_task"] = any(pl.here for pl in eng.placements.values())
    out["holds"] = sorted(k for k in tr.meta if getattr(tr, k) is not None)
    out["log"] = [(r["what"], r["iteration"]) for r in inj.log]
    return out


def launch_rank(device, job):
    """This rank's part of the launcher job: its ``launch_runs`` (the
    results dropped), then the job's extras."""
    root = job["cwd"]
    runs = launch_runs(job["runs"], root)
    out = {"rank": dist.rank(), "runs": {}}
    for name, r in runs.items():
        res = r.pop("result")
        out["runs"][name] = r
        if name == job.get("ckpt") and res is not None:
            os.chdir(os.path.join(root, name))
            out["ckpt"] = ckpt_roundtrip(res["trainer"], res["controller"],
                                         job["steps"], job["batch"])
        del res
    for extra in job.get("extras", ()):
        out[extra] = globals()[extra](device, job)
    return out


def launch_world1(job):
    """The job's extras in a world of one (this process)."""
    return {extra: globals()[extra](torch.device("cpu"), job)
            for extra in job.get("extras", ())}


def main(inp: str, out: str) -> None:
    import torch_sharded_ranks as me    # by name: the ranks import it
    torch.set_num_threads(1)
    with open(inp, "rb") as f:
        job = pickle.load(f)
    if job["kind"] == "steps":
        res = {"ranks": dist.spawn(me.steps_rank, job["world"], "cpu", job,
                                   timeout=job["timeout"])}
    elif job["kind"] == "genserve":
        res = {"ranks": dist.spawn(me.genserve_rank, job["world"], "cpu",
                                   job, timeout=job["timeout"]),
               "world1": me.serve_modes(torch.device("cpu"), job)}
    elif job["kind"] == "moe_mesh":
        res = {"ranks": dist.spawn(me.moe_mesh_rank, job["world"], "cpu",
                                   job, timeout=job["timeout"]),
               "world1": me.moe_mesh_run(torch.device("cpu"), job)}
    elif job["kind"] == "gen_rl":
        res = {"ranks": dist.spawn(me.gen_rl_rank, job["world"], "cpu", job,
                                   timeout=job["timeout"]),
               "world1": me.gen_rl_world1(job)}
    elif job["kind"] == "launch":
        res = {"ranks": dist.spawn(me.launch_rank, job["world"], "cpu", job,
                                   timeout=job["timeout"]),
               "world1": me.launch_world1(job)}
    elif job["kind"] == "swap":
        res = {"ranks": dist.spawn(me.swap_run, job["world"], "cpu", job,
                                   timeout=job["timeout"]),
               "world1": me.swap_run(torch.device("cpu"), job)}
    else:
        res = {"ranks": dist.spawn(me.exec_rank, job["world"], "cpu", job,
                                   timeout=job["timeout"]),
               "world1": me.exec_world1(job)}
    with open(out, "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    main(sys.argv[1], sys.argv[2])
