"""Per-task executors for the RL workflow graph.

Port of ``repro.engine.tasks``.  Each workflow task (GEN / INF / TRAIN)
has a registered executor that runs the real computation for that task
against the shared execution state ``st`` (the trainer's parameters,
optimizers and step functions) and the iteration blackboard ``bb``.  The
engine dispatches them stage by stage as the plan dictates; executors
return the tensor the engine should wait on when timing the task.

GEN and INF run under ``torch.inference_mode()`` on the default
attention path (the CUDA kernels on the card).  Their outputs are
inference tensors, so the training batch is built from clones
(``ensure_train_batch``).  TRAIN's losses run the plain attention
(the trainer passes ``attn_impl="plain"``): the kernels have no backward.

GEN takes ``RLConfig.gen_engine``, ``decode_chunk`` and ``prefill_chunk``
as the reference's does; injected decode-slot failures (the fault
injector's ``gen_slot_failures()``) and speculative decoding
(``RLConfig.spec_k``, with the draft of ``_draft_model``) force the
genserve engine.

A sharded placement (several ranks of a ``parallel.dist`` world) runs
its task on its ranks only: the input batch is sharded over ``data``
(``shard_batch``) and the trainer's ``sharded_*`` step runs on the
placement's mesh, as the reference's sharded dispatch
(``repro/engine/tasks.py:100-290``).  A step returns full tensors, so
what an executor writes to ``bb`` is the same on every rank of its
group; the engine sends it on to the other groups (``Engine._exchange``,
the counterpart of the reference's ``multidev`` host pulls).  A sharded
GEN that needs the genserve engine (a batch beyond one decode wave,
chunked admission, speculative decoding, slot failures) serves on the
placement's mesh (``genserve.generate(mesh=)``, the reference's
``mesh=placement.mesh``) with the DTensor ``gen_params`` and the draft
built alike on every GEN rank; its rollout comes back full on every GEN
rank.  One that fits a decode wave takes the single-wave path on the
mesh.  Sharded GEN and INF run under ``torch.no_grad()`` (DTensor views
refuse inference tensors).

Registration is by (TaskKind, task name), with a (TaskKind, None) fallback
so custom workflows can reuse the generic executor of a kind.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.core import plan as plan_mod
from repro_torch.core.workflow import Task, TaskKind
from repro_torch.genserve import adapter as genserve
from repro_torch.rl import gae, losses

_EXECUTORS: Dict[Tuple[TaskKind, Optional[str]], Callable] = {}


def register(kind: TaskKind, name: Optional[str] = None):
    def deco(fn):
        _EXECUTORS[(kind, name)] = fn
        return fn
    return deco


def executor_for(task: Task) -> Callable:
    fn = _EXECUTORS.get((task.kind, task.name)) \
        or _EXECUTORS.get((task.kind, None))
    if fn is None:
        raise KeyError(f"no executor registered for task "
                       f"{task.name!r} ({task.kind})")
    return fn


# ---------------------------------------------------------------------------
# GEN
# ---------------------------------------------------------------------------

def _draft_model(st):
    """The speculative-decoding draft of this trainer, resolved once and
    cached on ``st`` as ``_spec_draft`` = (config, params):
    ``rl.draft_arch`` names a configs.archs entry (the smoke variant when
    the target has at most 4 layers; vocab and dtype the target's, so
    the logits align), ``""`` a window-free copy of the target with
    ``len(pattern) * max(R // 4, 1)`` layers.  Weights are drawn from
    seed 7 on the trainer's device (on every GEN rank alike; a sharded
    GEN commits them to its mesh as the target's): a deployment would
    load a trained draft; acceptance rate, not weight quality, is what
    varies here."""
    cached = getattr(st, "_spec_draft", None)
    if cached is not None:
        return cached
    from repro_torch.configs import archs
    from repro_torch.models import transformer as T
    name = st.rl.draft_arch
    cfg = st.cfg
    if name:
        dcfg = dataclasses.replace(
            archs.get(name, smoke=cfg.n_layers <= 4),
            vocab_size=cfg.vocab_size, dtype=cfg.dtype)
    else:
        pattern = tuple(dataclasses.replace(s, window=None)
                        for s in cfg.pattern)
        dcfg = dataclasses.replace(
            cfg, name=f"{cfg.name}-draft", pattern=pattern,
            n_layers=len(pattern) * max(cfg.n_pattern_repeats // 4, 1))
    dparams = T.init_params(dcfg, seed=7, device=st.device)
    st._spec_draft = (dcfg, dparams)
    return st._spec_draft


def _mode(placement):
    """Inference context of GEN / INF: ``inference_mode`` on one device,
    ``no_grad`` on a mesh (DTensor views refuse inference tensors)."""
    return torch.no_grad() if placement.sharded else torch.inference_mode()


@register(TaskKind.GEN)
def run_generation(st, bb, placement):
    """Actor generation on the generation replica (pre-sync weights).

    Routed through the continuous-batching engine (``genserve``) when
    the rollout batch exceeds the plan's decode wave (``gen_engine
    "auto"``), when ``gen_engine`` is ``"genserve"``, when the fault
    injector schedules decode-slot failures (they only exist on the
    engine path), or with speculative decoding (``spec_k > 0``), so
    ``MAX_DECODE_WAVE`` semantics from the cost model are enforced at
    execution time; otherwise the single-wave rollout path.  Either way
    the wave stats land in ``bb["gen_stats"]`` for the engine's per-wave
    Event timeline."""
    prompts = bb["prompts_rep"]
    B = int(prompts.shape[0])
    wave = plan_mod.decode_wave(B)
    mode = st.rl.gen_engine
    injector = bb.get("fault")
    slot_failures = injector.gen_slot_failures() \
        if injector is not None else None
    spec_k = st.rl.spec_k
    draft_params, draft_cfg = None, None
    if spec_k > 0:
        draft_cfg, draft_params = _draft_model(st)
    use_engine = mode == "genserve" or (mode == "auto" and B > wave) \
        or slot_failures is not None or spec_k > 0
    with placement.mesh, _mode(placement):
        if use_engine:
            ro, stats = genserve.generate(
                st.gen_params, st.cfg, prompts, bb["rng"], st.sampler,
                wave=wave, decode_chunk=st.rl.decode_chunk,
                prefill_chunk=st.rl.prefill_chunk, fast_path=False,
                slot_failures=slot_failures, spec_k=spec_k,
                draft_params=draft_params, draft_cfg=draft_cfg,
                device=st.device,
                mesh=placement.mesh if placement.sharded else None)
        elif placement.sharded:
            # single-wave decode on the gen mesh: prompts split over
            # data, params TP-sharded, hints active
            prompts_d = placement.shard_batch(prompts)
            ro = st.sharded_generate(placement, prompts_d)(
                st.gen_params, prompts_d, bb["rng"])
            stats = genserve.wave_stats_from_mask(ro["mask"])
        else:
            ro = st._generate(st.gen_params, prompts=prompts,
                              rng=bb["rng"])
            # the single-wave path decodes all B rows at once — its wave
            # width is B, whatever the cost model's bound says
            stats = genserve.wave_stats_from_mask(ro["mask"])
    bb["gen_stats"] = stats
    bb["fresh"] = {"rollout": ro, "answers_rep": bb["answers_rep"],
                   "gen_start": bb["gen_start"],
                   "gen_version": st.weight_version}
    return ro["sequences"]


# ---------------------------------------------------------------------------
# INF
# ---------------------------------------------------------------------------

@register(TaskKind.INF, "reward_inference")
def run_reward(st, bb, placement):
    b = bb["bundle"]
    gen_np = b["rollout"]["gen_tokens"].cpu().numpy()
    scores = st.task.reward_batch(b["answers_rep"], gen_np)
    with bb["lock"]:
        bb["scores"] = scores
    return None


@register(TaskKind.INF, "reference_inference")
def run_reference(st, bb, placement):
    b = bb["bundle"]
    seqs = b["rollout"]["sequences"]
    with placement.mesh, _mode(placement):
        if placement.sharded:
            seqs = placement.shard_batch(seqs)
            lp_ref = st.sharded_ref_logp(placement, seqs)(
                st.ref, seqs, int(b["gen_start"]))
        else:
            lp_ref = st._ref_logp(st.ref, seqs, gen_start=b["gen_start"])
    with bb["lock"]:
        bb["lp_ref"] = lp_ref
    return lp_ref


@register(TaskKind.INF, "critic_inference")
def run_critic_inference(st, bb, placement):
    b = bb["bundle"]
    seqs = b["rollout"]["sequences"]
    with placement.mesh, _mode(placement):
        if placement.sharded:
            seqs = placement.shard_batch(seqs)
            values = st.sharded_critic_vals(placement, seqs)(
                st.critic, st.value_head, seqs, int(b["gen_start"]))
        else:
            values = st._critic_vals(st.critic, st.value_head, seqs,
                                     gen_start=b["gen_start"])
    with bb["lock"]:
        bb["values"] = values
    return values


# ---------------------------------------------------------------------------
# TRAIN (shared advantage preparation, then per-model update)
# ---------------------------------------------------------------------------

def ensure_train_batch(st, bb):
    """KL-penalised rewards + advantages, computed once per iteration.

    Both training executors may run concurrently on disjoint GPU groups;
    the first through the lock materializes the batch.  The rollout,
    reference and critic tensors were made under inference mode; the
    batch holds clones of them, which autograd may save."""
    with bb["lock"]:
        if "batch" in bb:
            return
        rl = st.rl
        b = bb["bundle"]
        ro = b["rollout"]
        mask = ro["mask"].clone()
        lp_old = ro["logprobs"].clone()
        lp_ref = bb["lp_ref"].clone()
        scores = torch.as_tensor(bb["scores"], device=mask.device)
        tok_rewards, kl = losses.kl_penalised_rewards(
            scores, lp_old, lp_ref, mask, kl_beta=rl.kl_beta)
        bb["metrics"].update({
            "reward_mean": float(bb["scores"].mean()),
            "kl": float(kl),
            "gen_len": float(mask.cpu().numpy().sum(1).mean()),
        })
        if rl.algorithm == "ppo":
            values = bb["values"].clone()
            adv, returns = gae.gae_advantages(
                tok_rewards, values * mask, mask,
                gamma=rl.gamma, lam=rl.lam)
            bb["returns"] = returns
        else:
            seq_reward = tok_rewards.cpu().numpy().sum(1)
            adv = gae.grpo_advantages(
                torch.as_tensor(seq_reward, device=mask.device),
                rl.n_rollouts, mask)
        if rl.whiten_advantages:
            adv = gae.whiten(adv, mask)
        bb["batch"] = {"sequences": ro["sequences"].clone(),
                       "logp_old": lp_old,
                       "advantages": adv, "mask": mask}


@register(TaskKind.TRAIN, "actor_training")
def run_actor_training(st, bb, placement):
    ensure_train_batch(st, bb)
    b = bb["bundle"]
    with placement.mesh:
        if placement.sharded:
            batch = placement.shard_batch(bb["batch"])
            st.actor, st.actor_opt, am = st.sharded_actor_step(
                placement, batch)(st.actor, st.actor_opt, batch,
                                  int(b["gen_start"]))
        else:
            st.actor, st.actor_opt, am = st._actor_step(
                st.actor, st.actor_opt, bb["batch"],
                gen_start=b["gen_start"])
    with bb["lock"]:
        bb["metrics"].update({k: float(v) for k, v in am.items()})
    return st.actor


@register(TaskKind.TRAIN, "critic_training")
def run_critic_training(st, bb, placement):
    ensure_train_batch(st, bb)
    b = bb["bundle"]
    mask = bb["batch"]["mask"]
    cbatch = dict(bb["batch"], values_old=bb["values"].clone() * mask,
                  returns=bb["returns"])
    with placement.mesh:
        if placement.sharded:
            cbatch = placement.shard_batch(cbatch)
            (st.critic, st.value_head), st.critic_opt, closs = \
                st.sharded_critic_step(placement, cbatch)(
                    (st.critic, st.value_head), st.critic_opt, cbatch,
                    int(b["gen_start"]))
        else:
            (st.critic, st.value_head), st.critic_opt, closs = \
                st._critic_step((st.critic, st.value_head), st.critic_opt,
                                cbatch, gen_start=b["gen_start"])
    with bb["lock"]:
        bb["metrics"]["critic_loss"] = float(closs)
    return closs
