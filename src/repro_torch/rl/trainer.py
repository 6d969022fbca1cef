"""RL trainers: synchronous PPO (6 tasks) and GRPO (4 tasks).

Port of ``repro.rl.trainer``.  The iteration structure mirrors the
paper's workflow graph exactly:
  actor_generation -> {reward, reference, critic} inference ->
  {actor, critic} training -> weight reshard/sync.

Execution is delegated to the plan-driven engine (``repro_torch.engine``):
the scheduler's ``Plan`` decides which tasks colocate (serialize) and
which GPU groups run concurrently, the async one-step off-policy double
buffer lives in ``engine.pipeline``, and every iteration records a
measured ``Event`` timeline comparable with ``core.simulator.simulate``.
The trainer is a thin facade that owns the state (params, optimizers,
step functions) the task executors operate on.

Differences from the reference, all forced by the framework:
  * weights are drawn from the port's own generators (``seed``), as
    ``T.init_params`` does; parity tests load the reference's state
    through ``bridge.from_numpy_state_tree``;
  * ``rng`` is an explicit ``torch.Generator`` on the device (None under
    greedy decoding);
  * the step functions are plain functions, not jitted: the losses take
    ``torch.autograd.grad`` over the flat parameter leaves (the stacked
    ``[R, ...]`` block leaves accumulate their per-repeat views'
    gradients) and run the plain attention (``attn_impl="plain"``,
    since the CUDA kernels have no backward); generation and inference
    keep the default attention (the kernels on the card);
  * sharded execution is SPMD over torch.distributed (one process per
    device, ``parallel.dist``): every rank builds the same trainer from
    the seed, ``install_placements`` keeps each task's state on the ranks
    of its owning placement only, as DTensors laid out by the
    reference's partition rules, and the ``sharded_*`` steps run the raw
    bodies on them under ``use_hints`` and DTensor's implicit replication
    of plain tensors (masks, positions, Adam's scalars).  A step gathers
    the FSDP-stored weights over ``data`` once at its start
    (``sharding.for_use``; the backward reduce-scatters the gradients to
    storage), shards the batch over ``data``, and returns full (plain)
    outputs, which cross to other groups as host arrays.  Sharded GEN and
    INF run under ``torch.no_grad()``: DTensor views refuse inference
    tensors.  A sampled sharded GEN draws the whole batch's random
    numbers on every gen rank (``sampling.sample_with_logprobs``), so
    its tokens are those of the unsharded run.  A checkpoint on ranks is
    ``gather_state_tree``: each key assembled by its owner and sent whole
    to one writing rank; ``restore_checkpoint`` reads it on one rank and
    moves each key onto its owner.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import numpy as np
import torch

from repro_torch.core import enumerate as enum_mod, topology, workflow
from repro_torch.data.synthetic import AdditionTask, EOS
from repro_torch.device import resolve_device
from repro_torch.engine.executor import Engine
from repro_torch.kernels.guard import TRAIN_ATTN
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adam
from repro_torch.parallel import dist
from repro_torch.parallel import sharding as sh
from repro_torch.rl import losses, rewards as rewards_mod, rollout
from repro_torch.rl.sync import OnRank, gather, meta_tree, transfer
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten



@dataclasses.dataclass(frozen=True)
class RLConfig:
    algorithm: str = "grpo"          # "ppo" | "grpo"
    clip_eps: float = 0.2
    kl_beta: float = 0.02
    gamma: float = 1.0
    lam: float = 0.95
    value_coef: float = 0.5
    entropy_coef: float = 0.0
    n_rollouts: int = 4              # responses per prompt (GRPO group)
    max_new_tokens: int = 8
    temperature: float = 1.0
    # greedy decode: deterministic argmax sampling — what parity checks
    # pin token-identical generation on
    greedy: bool = False
    whiten_advantages: bool = True
    lr: float = 1e-4
    # asynchronous (one-step off-policy) RL: generation for iteration t+1
    # overlaps training on iteration t's rollouts (§2.1); the PPO ratio
    # absorbs the one-step staleness of logp_old
    asynchronous: bool = False
    # GEN executor routing: "auto" takes the single-wave path when the
    # rollout batch fits in one decode wave and the continuous-batching
    # engine (genserve) beyond it; "rollout"/"genserve" force a path
    gen_engine: str = "auto"
    decode_chunk: int = 1            # genserve decode steps per host round
    prefill_chunk: int = 0           # genserve chunked admission (tokens
    #                                  per mixed round; 0 = one-shot)
    # draft-model speculative decoding inside the wave step: k tokens
    # proposed by the draft per round, one batched (k+1)-wide target
    # verify.  0 = off.  ``draft_arch`` names a configs.archs entry for
    # the draft ("" = a scaled-down copy of the target); always routes
    # through the genserve engine.
    spec_k: int = 0
    draft_arch: str = ""


def default_plan(wf: workflow.RLWorkflow, n_devices: Optional[int] = None):
    """Colocate-all plan over the host devices (what a plan-less trainer
    executes): one task group, every task on every device."""
    n = n_devices or 1
    topo = topology.build_host(n)
    grouping = (tuple(range(wf.n_tasks)),)
    return topo, enum_mod.build_plan(topo, wf, grouping, [n],
                                     list(range(n)))


def _with_grad_leaves(tree):
    """(tree of fresh leaves that require grad, the flat leaf list)."""
    flat = [p.detach().requires_grad_(True) for p in tree_leaves(tree)]
    return tree_unflatten(tree, flat), flat


def _grads(loss, flat):
    gs = torch.autograd.grad(loss, flat, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g for p, g in zip(flat, gs)]


class RLTrainer:
    def __init__(self, model_cfg: ModelConfig, rl_cfg: RLConfig,
                 task: AdditionTask, seed: int = 0, plan=None, topo=None,
                 wf=None,
                 device: Union[str, torch.device] = "cuda",
                 overlap: Optional[bool] = None):
        self.cfg = model_cfg
        self.rl = rl_cfg
        self.task = task
        self.device = resolve_device(device)
        if dist.multi():
            self.device = dist.rank_devices(self.device)[dist.rank()].device
        self.actor = T.init_params(model_cfg, seed=seed, device=self.device)
        self.ref = tree_map(torch.clone, self.actor)
        self.actor_opt = adam.init_adam_state(
            self.actor, adam.AdamConfig(lr=rl_cfg.lr))
        self.gen_params = self.actor  # generation replica (synced weights)
        self.sync_bytes = 0
        self.weight_version = 0
        if rl_cfg.algorithm == "ppo":
            self.critic = T.init_params(model_cfg, seed=seed + 1,
                                        device=self.device)
            vh_gen = torch.Generator(device=self.device).manual_seed(seed + 2)
            self.value_head = rewards_mod.init_value_head(vh_gen, model_cfg)
            self.critic_opt = adam.init_adam_state(
                (self.critic, self.value_head),
                adam.AdamConfig(lr=rl_cfg.lr))
        self.sampler = rollout.SamplerConfig(
            max_new_tokens=rl_cfg.max_new_tokens,
            temperature=rl_cfg.temperature, eos_token=EOS,
            greedy=rl_cfg.greedy)

        # plan-driven engine: the plan decides task colocation/concurrency
        # and the sync path; without one, execute the colocate-all default.
        # Pass the workflow the plan was searched with (its global_batch
        # scales the cost model) so measured-vs-predicted compares like
        # with like; otherwise a representative one is built here.
        if wf is not None and wf.algorithm != rl_cfg.algorithm:
            raise ValueError(f"workflow algorithm {wf.algorithm!r} != "
                             f"rl config algorithm {rl_cfg.algorithm!r}")
        self.wf = wf or workflow.make_workflow(
            rl_cfg.algorithm,
            workflow.LLMSpec.from_model_config(model_cfg),
            synchronous=not rl_cfg.asynchronous,
            n_rollouts=rl_cfg.n_rollouts,
            seq_in=getattr(task, "prompt_len", 16),
            seq_out=rl_cfg.max_new_tokens,
            global_batch=1)
        if plan is not None and \
                set(plan.parallel) != set(range(self.wf.n_tasks)):
            raise ValueError(
                f"plan covers tasks {sorted(plan.parallel)} but the "
                f"{rl_cfg.algorithm} workflow has {self.wf.n_tasks} tasks")
        if plan is None:
            host_topo, plan = default_plan(self.wf)
            topo = topo if topo is not None else host_topo
        # the state's shapes, for ranks that come to hold none of it
        self.meta = {k: meta_tree(v) for k, v in self._owned().items()}
        self._owners: Dict[str, object] = {}   # state key -> placement
        self._shard_cache: Dict[tuple, object] = {}
        # the engine folds the plan onto the world's ranks (one process
        # per device), or every plan group onto this trainer's device
        devices = dist.rank_devices(self.device) if dist.multi() \
            else [self.device]
        self.engine = Engine(self.wf, plan, self, topo=topo,
                             asynchronous=rl_cfg.asynchronous,
                             devices=devices, overlap=overlap)

    @property
    def plan(self):
        """The plan the engine executes."""
        return self.engine.plan

    # -- checkpointable state ------------------------------------------
    def state_tree(self) -> Dict[str, object]:
        """The full live training state as one tree: parameters,
        optimizer state, the generation replica and the weight-sync
        version counter (``bridge.to_numpy_state_tree`` carries it to
        numpy).  Execution state (plan, placements, timeline) is
        deliberately excluded — it is rebuilt from the plan on restore."""
        tree: Dict[str, object] = {
            "actor": self.actor, "ref": self.ref,
            "actor_opt": self.actor_opt, "gen_params": self.gen_params,
            "weight_version": torch.tensor(self.weight_version,
                                           dtype=torch.int32),
        }
        if self.rl.algorithm == "ppo":
            tree["critic"] = self.critic
            tree["value_head"] = self.value_head
            tree["critic_opt"] = self.critic_opt
        return tree

    def gather_state_tree(self, dst: int = 0) -> Optional[Dict[str, object]]:
        """``state_tree()`` whole, for one writer.  In a world of one it
        is ``state_tree()``; on ranks every rank calls it, each state
        key's owner placement assembles it leaf by leaf and its lead
        sends it to rank ``dst`` (``rl.sync.gather``), which gets the
        tree as host tensors; the other ranks get None."""
        if not dist.multi():
            return self.state_tree()
        out: Dict[str, object] = {}
        for key, _ in self._OWNERS:
            if key not in self.meta:
                continue
            # a key no placement owns lies whole on every rank
            src = self._owners.get(key) or OnRank(dst)
            out[key] = gather(getattr(self, key), src, dst,
                              template=self.meta[key])
        if dist.rank() != dst:
            return None
        out["weight_version"] = torch.tensor(self.weight_version,
                                             dtype=torch.int32)
        return out

    def load_state_tree(self, tree: Optional[Dict[str, object]], *,
                        src: Optional[int] = None) -> None:
        """Take ``tree`` (a ``state_tree()``) as the live state.  On
        ranks, with ``src`` None every rank passes the whole tree, as at
        construction; with ``src`` only that rank does (a checkpoint read
        there; the others pass None).  Either way each state key then
        moves onto its owning placement."""
        if src is not None and dist.multi():
            version = dist.broadcast_object(
                int(tree["weight_version"]) if dist.rank() == src
                else None, src)
            tree = tree if dist.rank() == src else \
                {k: None for k in self.meta}
            tree["weight_version"] = version
        self.actor = tree["actor"]
        self.ref = tree["ref"]
        self.actor_opt = tree["actor_opt"]
        self.gen_params = tree["gen_params"]
        self.weight_version = int(tree["weight_version"])
        if self.rl.algorithm == "ppo":
            self.critic = tree["critic"]
            self.value_head = tree["value_head"]
            self.critic_opt = tree["critic_opt"]
        if dist.multi():
            # re-own it: from every rank (the whole state, as at
            # construction) or from ``src`` alone
            self._owners.clear()
            if src is not None:
                self._owners.update({k: OnRank(src) for k in self.meta})
            self.install_placements(self.engine.placements, self.wf)

    def state_like(self) -> Dict[str, object]:
        """Empty tensors on this trainer's device shaped like the whole
        ``state_tree()``: what ``checkpoint.io.restore`` fills on a rank
        that may hold none of the state."""
        tree = {k: tree_map(lambda m: torch.empty(
            tuple(m.shape), dtype=m.dtype, device=self.device), v)
            for k, v in self.meta.items()}
        tree["weight_version"] = torch.tensor(0, dtype=torch.int32)
        return tree

    def restore_checkpoint(self, path: str, src: int = 0) -> None:
        """Load the checkpoint at ``path`` (``checkpoint.io``'s file):
        rank ``src`` reads it (every rank calls it) and each state key
        moves onto its owning placement, as ``load_state_tree`` moves
        it; in a world of one, the file onto this trainer's device."""
        from repro_torch.checkpoint import io as ckpt_io
        if not dist.multi():
            self.load_state_tree(ckpt_io.restore(path, self.state_tree()))
            return
        tree, err = None, None
        if dist.rank() == src:
            try:
                tree = ckpt_io.restore(path, self.state_like())
            except ckpt_io.CheckpointError as e:
                err = str(e)
        err = dist.broadcast_object(err, src)
        if err is not None:
            raise ckpt_io.CheckpointError(err)
        self.load_state_tree(tree, src=src)

    # -- step functions ---------------------------------------------------
    def _generate(self, params, prompts, rng):
        return rollout.generate(params, self.cfg, prompts, rng, self.sampler)

    def _ref_logp(self, params, sequences, gen_start: int):
        lp, _ = rollout.sequence_logprobs(params, self.cfg, sequences,
                                          gen_start)
        return lp

    def _actor_loss(self, params, batch, gen_start: int):
        lp_new, out = rollout.sequence_logprobs(
            params, self.cfg, batch["sequences"], gen_start,
            attn_impl=TRAIN_ATTN)
        pl = losses.ppo_policy_loss(
            lp_new, batch["logp_old"], batch["advantages"], batch["mask"],
            clip_eps=self.rl.clip_eps)
        loss = pl["loss"] + out["aux_loss"]
        if self.rl.entropy_coef:
            logits = out["logits"][:, gen_start - 1:-1]
            loss = loss - self.rl.entropy_coef * losses.entropy_bonus(
                logits, batch["mask"])
        return loss, pl

    def actor_grads(self, params, batch, gen_start: int):
        """(loss, policy-loss metrics, gradient tree like ``params``)."""
        with torch.enable_grad():
            tp, flat = _with_grad_leaves(params)
            loss, pl = self._actor_loss(sh.for_use(tp), batch, gen_start)
            grads = tree_unflatten(params, _grads(loss, flat))
        return loss.detach(), {k: v.detach() for k, v in pl.items()}, grads

    def _actor_step(self, params, opt_state, batch, gen_start: int):
        loss, pl, grads = self.actor_grads(params, batch, gen_start)
        new_params, new_opt, om = adam.adam_update(
            params, grads, opt_state, adam.AdamConfig(lr=self.rl.lr))
        return new_params, new_opt, {**pl, "loss": loss, **om}

    def _critic_vals(self, critic, head, sequences, gen_start: int):
        return rewards_mod.critic_values(critic, head, self.cfg, sequences,
                                         gen_start)

    def _critic_loss(self, cp, batch, gen_start: int):
        critic, head = cp
        v = rewards_mod.critic_values(critic, head, self.cfg,
                                      batch["sequences"], gen_start,
                                      attn_impl=TRAIN_ATTN)
        return self.rl.value_coef * losses.value_loss(
            v, batch["values_old"], batch["returns"], batch["mask"],
            clip_eps=self.rl.clip_eps)

    def critic_grads(self, cp, batch, gen_start: int):
        """(loss, gradient tree like ``cp = (critic, value_head)``)."""
        with torch.enable_grad():
            tcp, flat = _with_grad_leaves(cp)
            loss = self._critic_loss(sh.for_use(tcp), batch, gen_start)
            grads = tree_unflatten(cp, _grads(loss, flat))
        return loss.detach(), grads

    def _critic_step(self, cp, opt_state, batch, gen_start: int):
        loss, grads = self.critic_grads(cp, batch, gen_start)
        new_cp, new_opt, _ = adam.adam_update(
            cp, grads, opt_state, adam.AdamConfig(lr=self.rl.lr))
        return new_cp, new_opt, loss

    # -- sharded execution (plan -> meshes -> DTensors) -----------------
    #
    # Every rank runs this trainer.  ``install_placements`` leaves each
    # task's state on the ranks of its owning placement (DTensors on its
    # mesh when it spans several ranks, plain tensors on its one rank)
    # and None elsewhere; the ``sharded_*`` steps are cached per
    # (name, mesh) and take DTensors in, full tensors out.

    # state key -> owning task (the reference's ownership)
    _OWNERS = (("actor", "actor_training"), ("actor_opt", "actor_training"),
               ("ref", "reference_inference"),
               ("gen_params", "actor_generation"),
               ("critic", "critic_training"),
               ("value_head", "critic_training"),
               ("critic_opt", "critic_training"))

    def _owned(self) -> Dict[str, object]:
        return {k: getattr(self, k) for k, _ in self._OWNERS
                if hasattr(self, k)}

    def _layout(self, key: str, placement):
        """``ParamShardings`` of state ``key`` on ``placement``: the
        parameters' specs, an optimizer state's moments like its
        parameters and its step replicated."""
        from repro_torch.engine.placement import ParamShardings
        params_of = {"actor_opt": "actor", "critic_opt": ("critic",
                                                          "value_head")}
        meta = self.meta
        if key not in params_of:
            return placement.param_shardings(meta[key])
        src = params_of[key]
        ptree = tuple(meta[k] for k in src) if isinstance(src, tuple) \
            else meta[src]
        ps = placement.param_shardings(ptree).specs
        if ps is None:
            return ParamShardings(placement, None)
        return ParamShardings(placement, {"step": sh.P(), "m": ps, "v": ps})

    def _sharded(self, name: str, placement, build):
        key = (name, id(placement.mesh))
        fn = self._shard_cache.get(key)
        if fn is None:
            fn = self._shard_cache[key] = build()
        return fn

    def install_placements(self, placements, wf) -> None:
        """Commit each task's state onto its owning placement.

        Called by the engine whenever placements (re)build — initial
        construction and every elastic plan swap.  Ownership: actor +
        optimizer -> actor_training; reference -> reference_inference;
        generation replica -> actor_generation; critic state ->
        critic_training (critic_inference without one).  In a world of
        one rank every placement folds onto this trainer's device and
        nothing moves.  Otherwise every rank takes part: the state moves
        from its previous owner (at construction every rank holds it
        whole) to the new owner's ranks (``rl.sync.transfer``)."""
        self._shard_cache.clear()
        if not dist.multi():
            devs = {d for pl in placements.values() for d in pl.local_devices}
            if len(devs) > 1:
                from repro_torch.engine.placement import ONE_RANK
                raise RuntimeError(ONE_RANK)
            return
        by_name = {wf.tasks[t].name: pl for t, pl in placements.items()}
        for key, owner in self._OWNERS:
            if key not in self.meta:
                continue
            pl = by_name.get(owner)
            if pl is None and key.startswith(("critic", "value_head")):
                pl = by_name.get("critic_inference")
            if pl is None:
                continue
            setattr(self, key, self._move(key, pl))

    def _move(self, key: str, pl):
        """State ``key`` onto placement ``pl`` (every rank calls it)."""
        target = self._layout(key, pl)
        old = self._owners.get(key)
        self._owners[key] = pl
        tree = getattr(self, key)
        if old is None:
            # construction: every rank holds the whole state
            if not pl.here:
                return None
            return pl.distribute_params(tree, target) if pl.sharded \
                else tree
        return transfer(tree, old, target, template=self.meta[key])

    def _step_in(self, placement):
        """Context of a sharded step: the placement's hints, and plain
        tensors taken as replicated DTensors."""
        from contextlib import ExitStack
        from torch.distributed.tensor.experimental import implicit_replication
        stack = ExitStack()
        stack.enter_context(sh.use_hints(placement.activation_rules()))
        stack.enter_context(implicit_replication())
        return stack

    def _train_step(self, placement, grads_fn, params, opt_state, batch,
                    gen_start):
        """grads -> Adam on DTensor leaves; (params, opt, metrics) with
        the metrics full."""
        with self._step_in(placement):
            out = grads_fn(params, batch, gen_start)
            grads = tree_map(sh.redistribute_like, out[-1], params)
            new_p, new_opt, om = adam.adam_update(
                params, grads, opt_state, adam.AdamConfig(lr=self.rl.lr))
        return new_p, new_opt, out[:-1], sh.full_tree(om)

    def sharded_actor_step(self, placement, batch):
        """(params, opt, batch, gen_start) -> (params, opt, metrics) on
        the placement's mesh: the batch sharded over ``data``, the
        parameters and moments DTensors laid out by their specs."""
        def build():
            def step(params, opt_state, batch, gen_start):
                new_p, new_opt, (loss, pl), om = self._train_step(
                    placement, self.actor_grads, params, opt_state, batch,
                    gen_start)
                metrics = sh.full_tree({**pl, "loss": loss})
                return new_p, new_opt, {**metrics, **om}
            return step
        return self._sharded("actor_step", placement, build)

    def sharded_ref_logp(self, placement, sequences):
        def build():
            def step(params, sequences, gen_start):
                with torch.no_grad(), self._step_in(placement):
                    return sh.full(self._ref_logp(sh.for_use(params),
                                                  sequences, gen_start))
            return step
        return self._sharded("ref_logp", placement, build)

    def sharded_generate(self, placement, prompts, sampler=None):
        """(params, prompts, rng) single-wave decode on the gen mesh
        (``sampler``: the trainer's when None); the rollout comes back
        full on every gen rank."""
        sampler = sampler or self.sampler

        def build():
            def step(params, prompts, rng):
                with torch.no_grad(), self._step_in(placement):
                    return sh.full_tree(rollout.generate(
                        sh.for_use(params), self.cfg, prompts, rng,
                        sampler))
            return step
        return self._sharded(("generate", sampler), placement, build)

    def sharded_critic_vals(self, placement, sequences):
        def build():
            def step(critic, head, sequences, gen_start):
                with torch.no_grad(), self._step_in(placement):
                    return sh.full(self._critic_vals(
                        sh.for_use(critic), sh.for_use(head), sequences,
                        gen_start))
            return step
        return self._sharded("critic_vals", placement, build)

    def sharded_critic_step(self, placement, batch):
        def build():
            def step(cp, opt_state, batch, gen_start):
                new_cp, new_opt, (loss,), _ = self._train_step(
                    placement, self.critic_grads, cp, opt_state, batch,
                    gen_start)
                return new_cp, new_opt, sh.full(loss)
            return step
        return self._sharded("critic_step", placement, build)

    # -- engine hooks ---------------------------------------------------
    def prepare_inputs(self, prompts: np.ndarray, answers: np.ndarray,
                       rng) -> Dict[str, object]:
        G = self.rl.n_rollouts
        rep = np.repeat(prompts, G, axis=0).astype(np.int64)
        return {"prompts_rep": torch.as_tensor(rep, device=self.device),
                "answers_rep": np.repeat(answers, G, axis=0),
                "gen_start": prompts.shape[1], "rng": rng}

    def before_stage(self, stage_tasks, bb) -> None:
        """Materialize the shared KL/advantage batch before the training
        stage dispatches, so neither training lane's measured duration
        absorbs the cross-task prep (or the other lane's lock wait)."""
        from repro_torch.core.workflow import TaskKind
        from repro_torch.engine.tasks import ensure_train_batch
        if bb.get("bundle") is not None and \
                any(t.kind == TaskKind.TRAIN for t in stage_tasks):
            ensure_train_batch(self, bb)

    def fill_metrics(self) -> Dict[str, float]:
        return {"reward_mean": 0.0, "kl": 0.0, "gen_len": 0.0,
                "loss": 0.0, "pipeline_fill": 1.0, "sync_gb": 0.0}

    # ------------------------------------------------------------------
    def iteration(self, prompts: np.ndarray, answers: np.ndarray,
                  rng: Optional[torch.Generator]) -> Dict[str, float]:
        """One RL iteration over a prompt batch, executed by the engine.

        Synchronous: generate -> infer -> train -> sync (iteration-level
        barrier).  Asynchronous: generate with the PREVIOUS sync's weights
        while training on the PREVIOUS iteration's rollouts (one-step
        off-policy); the first call only produces rollouts."""
        with obs_trace.span("train.step", batch=int(prompts.shape[0])):
            res = self.engine.run_iteration(prompts, answers, rng)
        return res.metrics

    # ------------------------------------------------------------------
    def evaluate(self, prompts: np.ndarray, answers: np.ndarray,
                 rng: Optional[torch.Generator]) -> float:
        """Greedy exact-match accuracy of the generation replica.  In a
        world of several ranks every rank calls it: the GEN ranks decode
        on their placement (sharded over its mesh when it spans several
        ranks) and the GEN lead's score reaches every rank."""
        sampler = dataclasses.replace(self.sampler, greedy=True)
        prompts_t = torch.as_tensor(prompts, device=self.device)
        score = None
        pl = self.engine.placements[self.engine.ctx.gen_task] \
            if dist.multi() else None
        if pl is None or (pl.here and not pl.sharded):
            with torch.inference_mode():
                ro = rollout.generate(self.gen_params, self.cfg, prompts_t,
                                      rng, sampler)
        elif pl.here:
            pd = pl.shard_batch(prompts_t)
            with pl.mesh:
                ro = self.sharded_generate(pl, pd, sampler)(
                    self.gen_params, pd, rng)
        if pl is None or pl.here:
            gen_np = ro["gen_tokens"].cpu().numpy()
            score = float(np.mean([self.task.reward(a, g) >= 1.0
                                   for a, g in zip(answers, gen_np)]))
        if pl is not None:
            score = dist.broadcast_object(score, pl.lead)
        return score
