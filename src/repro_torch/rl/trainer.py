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
  * sharded execution over several devices is not yet ported: the
    ``sharded_*`` step factories and a multi-device ``install_placements``
    raise ``NotImplementedError``.
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
from repro_torch.engine.placement import NOT_PORTED
from repro_torch.kernels.guard import TRAIN_ATTN
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.obs import trace as obs_trace
from repro_torch.optim import adam
from repro_torch.rl import losses, rewards as rewards_mod, rollout
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
                 device: Union[str, torch.device] = "cuda"):
        self.cfg = model_cfg
        self.rl = rl_cfg
        self.task = task
        self.device = resolve_device(device)
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
        # the engine folds every plan group onto this trainer's device
        self.engine = Engine(self.wf, plan, self, topo=topo,
                             asynchronous=rl_cfg.asynchronous,
                             devices=[self.device])

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

    def load_state_tree(self, tree: Dict[str, object]) -> None:
        self.actor = tree["actor"]
        self.ref = tree["ref"]
        self.actor_opt = tree["actor_opt"]
        self.gen_params = tree["gen_params"]
        self.weight_version = int(tree["weight_version"])
        if self.rl.algorithm == "ppo":
            self.critic = tree["critic"]
            self.value_head = tree["value_head"]
            self.critic_opt = tree["critic_opt"]

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
            loss, pl = self._actor_loss(tp, batch, gen_start)
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
            loss = self._critic_loss(tcp, batch, gen_start)
            grads = tree_unflatten(cp, _grads(loss, flat))
        return loss.detach(), grads

    def _critic_step(self, cp, opt_state, batch, gen_start: int):
        loss, grads = self.critic_grads(cp, batch, gen_start)
        new_cp, new_opt, _ = adam.adam_update(
            cp, grads, opt_state, adam.AdamConfig(lr=self.rl.lr))
        return new_cp, new_opt, loss

    # -- sharded execution (not yet ported) -------------------------------
    def install_placements(self, placements, wf) -> None:
        """Commit each task's state onto its owning placement: nothing to
        do when every placement folds onto this trainer's one device;
        several devices need sharded execution, which is not yet
        ported."""
        devs = {id(d) for pl in placements.values()
                for d in pl.local_devices}
        if len(devs) > 1 or any(pl.sharded for pl in placements.values()):
            raise NotImplementedError(NOT_PORTED)

    def sharded_actor_step(self, placement, batch):
        raise NotImplementedError(NOT_PORTED)

    def sharded_ref_logp(self, placement, sequences):
        raise NotImplementedError(NOT_PORTED)

    def sharded_generate(self, placement, prompts):
        raise NotImplementedError(NOT_PORTED)

    def sharded_critic_vals(self, placement, sequences):
        raise NotImplementedError(NOT_PORTED)

    def sharded_critic_step(self, placement, batch):
        raise NotImplementedError(NOT_PORTED)

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
        sampler = dataclasses.replace(self.sampler, greedy=True)
        with torch.inference_mode():
            ro = rollout.generate(
                self.gen_params, self.cfg,
                torch.as_tensor(prompts, device=self.device), rng, sampler)
        gen_np = ro["gen_tokens"].cpu().numpy()
        exact = [self.task.reward(a, g) >= 1.0
                 for a, g in zip(answers, gen_np)]
        return float(np.mean(exact))
