"""Elasticity controller: the §6 online-redeployment loop over a live
engine.

``ElasticController`` watches a topology feed (a
``core.topology.DriftSchedule`` or any ``iteration -> Topology``
callable) and, at iteration boundaries, reacts to drift exactly as the
paper prescribes: re-run the scheduler with a short warm-start budget
(``core.redeploy.reschedule``), checkpoint the live trainer state through
``checkpoint.io`` (the paper's "during model checkpointing"), and apply
or reject the plan per the ``RedeployDecision`` — a ``switch=True``
decision swaps the engine's plan context through ``Engine.apply_plan``
with trainer/optimizer state untouched, a ``switch=False`` decision keeps
the incumbent but still adopts the drifted topology for predictions.

Reactive drift (no feed change, the ``DivergenceMonitor`` fired): the
controller replans against the *measured* topology —
``obs.calibrate.infer_drifted_topology`` turns the monitor's per-task
ratios into the environment the measurements describe — so the scheduler
can actually route around an undeclared degradation instead of
rediscovering the incumbent on the pristine believed topology.

Failure escalation (``handle_failure``): a ``TaskExecutionError`` whose
retries are exhausted or that is permanent drops the dead devices from
the believed topology and forces a replan+swap onto the survivors.

Checkpoint writes go through ``core.retry`` with bounded backoff; a
persistently failing checkpoint path degrades to warn-and-continue
(metric ``checkpoint.failures``) instead of killing the training loop.

In a world of several ranks every rank runs the controller (SPMD) and
rank 0 decides for all: its ``reschedule`` and the topology it searched
are broadcast, so every rank swaps to the same plan; a checkpoint is
the state gathered whole onto rank 0 (``RLTrainer.gather_state_tree``),
which alone writes it, and its outcome (path and bytes, or the warning's
``(None, 0)``) and what the fault injector did to it reach every rank.
"""
from __future__ import annotations

import dataclasses
import os
import time
import warnings
from typing import Callable, Dict, List, Optional, Union

from repro_torch.core import retry as retry_mod
from repro_torch.core.redeploy import RedeployDecision, reschedule
from repro_torch.core.topology import (DriftSchedule, Topology, drop_devices,
                                 topo_equal)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.parallel import dist


@dataclasses.dataclass(frozen=True)
class ElasticConfig:
    budget: int = 150              # reschedule's warm-started eval budget
    amortization_iters: int = 20   # horizon a new plan must pay back over
    ckpt_dir: Optional[str] = None  # checkpoint around the switch when set
    ckpt_retain: int = 3           # keep the newest K checkpoints (0 = all)
    ckpt_retry: retry_mod.RetryPolicy = retry_mod.RetryPolicy(
        max_attempts=3, base_delay_s=0.05)
    carry_pending: bool = True     # carry vs drain the async bundle
    cooldown_iters: int = 3        # iterations to ignore reactive fires
    #                                after any swap (let the EWMA settle)
    seed: int = 0


@dataclasses.dataclass
class AdaptRecord:
    """One reaction to observed drift (whether or not a swap happened)."""
    iteration: int
    decision: RedeployDecision
    applied: bool                  # True when the engine swapped plans
    epoch: int                     # engine plan epoch after the reaction
    reschedule_s: float            # wall-clock spent in the scheduler
    ckpt_path: Optional[str] = None
    ckpt_bytes: int = 0
    transition: Dict[str, float] = dataclasses.field(default_factory=dict)
    reactive: bool = False         # fired by the divergence monitor, not
    #                                an observed topology change
    forced: bool = False           # failure escalation (handle_failure)


class ElasticController:
    """Drive ``poll(iteration)`` once per finished iteration (the
    boundary where §6 allows a swap).  Drift is detected structurally —
    the feed may return the same object every call."""

    def __init__(self, trainer,
                 feed: Union[DriftSchedule, Callable[[int], Topology]],
                 cfg: Optional[ElasticConfig] = None,
                 monitor=None):
        self.trainer = trainer
        self.feed = feed
        self.cfg = cfg or ElasticConfig()
        self.records: List[AdaptRecord] = []
        # _topo: the environment we currently believe in (may be an
        # inferred measured topology after a reactive replan);
        # _observed: the feed's last value — feed drift is detected
        # against this, so adopting an inferred topology does not make
        # the unchanged feed look like fresh structural drift forever.
        self._topo = trainer.engine.topo
        self._observed = trainer.engine.topo
        self._cooldown_until = -1
        # optional obs.calibrate.DivergenceMonitor: sustained measured/
        # predicted drift fires a reschedule against the *measured*
        # topology even when the feed reports no structural change —
        # the reactive half of "calibrated cost model + reactive
        # elasticity".  The engine must be feeding the monitor
        # (Engine.attach_divergence_monitor) for it to ever fire.
        self.monitor = monitor

    def _observe(self, iteration: int) -> Optional[Topology]:
        if hasattr(self.feed, "topo_at"):
            return self.feed.topo_at(iteration)
        return self.feed(iteration)

    # -- checkpointing ---------------------------------------------------
    def _checkpoint(self, iteration: int) -> tuple:
        """Write the trainer state tree with bounded retry; a
        persistently failing path warns and continues (the §6 swap is
        still applied — recovery just has an older restore point).
        Returns (path, bytes) — (None, 0) when disabled or failed."""
        cfg = self.cfg
        if not cfg.ckpt_dir:
            return None, 0
        path = os.path.join(cfg.ckpt_dir,
                            f"elastic_iter{iteration:05d}.msgpack")
        injector = getattr(self.trainer.engine, "fault_injector", None)
        t0 = time.monotonic()
        with obs_trace.span("elastic.checkpoint_gather"):
            tree = self.trainer.gather_state_tree()
        obs_metrics.histogram("elastic.ckpt_gather_s").observe(
            time.monotonic() - t0)
        if not dist.multi():
            return self._write(path, tree, injector)
        # one writer, rank 0, which holds the whole tree; its outcome
        # (and what the injector did to it) is every rank's
        out, delta, err = None, None, None
        if dist.rank() == 0:
            mark = injector.mark() if injector is not None else None
            try:
                out = self._write(path, tree, injector)
            except Exception as e:          # raised on every rank below
                err = e
            delta = injector.since(mark) if injector is not None else None
        del tree
        out, delta, why = dist.broadcast_object(
            (out, delta, None if err is None else repr(err)), 0)
        if err is not None:
            raise err
        if why is not None:
            raise RuntimeError(f"the checkpoint's writer (rank 0) failed: "
                               f"{why}")
        if dist.rank() != 0 and injector is not None:
            injector.absorb(delta)
        return out

    def _write(self, path: str, tree, injector) -> tuple:
        from repro_torch.checkpoint import io as ckpt_io
        cfg = self.cfg

        def write(attempt: int) -> int:
            if injector is not None:
                injector.maybe_fail_checkpoint(attempt)
            return ckpt_io.save(path, tree, retain=cfg.ckpt_retain)

        def on_retry(attempt: int, exc: BaseException) -> None:
            obs_metrics.counter("checkpoint.retries").inc()

        t0 = time.monotonic()
        try:
            with obs_trace.span("elastic.checkpoint"):
                nbytes = retry_mod.retry_call(
                    write, policy=cfg.ckpt_retry,
                    retry_on=(retry_mod.TransientError, OSError),
                    on_retry=on_retry)
        except (retry_mod.RetryExhausted, OSError) as e:
            obs_metrics.counter("checkpoint.failures").inc()
            warnings.warn(f"checkpoint write failed, continuing without: "
                          f"{e}", RuntimeWarning, stacklevel=3)
            return None, 0
        obs_metrics.histogram("elastic.ckpt_write_s").observe(
            time.monotonic() - t0)
        if injector is not None:
            injector.maybe_corrupt_checkpoint(path)
        obs_metrics.counter("elastic.checkpoint_bytes").inc(nbytes)
        return path, nbytes

    def checkpoint_now(self, iteration: int) -> tuple:
        """Out-of-band periodic checkpoint through the same retry- and
        corruption-hardened path the drift reaction uses.  Returns
        (path, bytes) — (None, 0) when disabled or abandoned."""
        return self._checkpoint(iteration)

    # -- drift reaction --------------------------------------------------
    def poll(self, iteration: int) -> Optional[AdaptRecord]:
        """Check the feed (and the divergence monitor, when attached);
        on drift, reschedule / checkpoint / apply.  Returns the record
        when drift was handled, None when quiet."""
        observed = self._observe(iteration)
        drifted = observed is not None \
            and not topo_equal(observed, self._observed)
        fired = self.monitor is not None and self.monitor.consume()
        reactive = (not drifted and fired
                    and iteration >= self._cooldown_until)
        if dist.multi():
            # rank 0 decides for the world (every rank sees the same
            # feed and the same gathered timeline, so they agree anyway)
            drifted, reactive = dist.broadcast_object((drifted, reactive),
                                                      0)
        if not drifted and not reactive:
            return None
        topo_old = self._topo
        if drifted:
            topo = observed
            self._observed = observed
        else:
            # no structural change observed, but measurements say the
            # belief is wrong: replan against the topology the
            # measurements describe, not the pristine believed one — a
            # warm-started search on the believed topology would only
            # rediscover the incumbent
            topo = self._infer_measured_topology() or self._topo
        trainer, cfg = self.trainer, self.cfg
        with obs_trace.span("elastic.poll", iteration=iteration,
                            reactive=reactive):
            topo, decision, resched_s = self._reschedule(topo, topo_old)
            self._topo = topo
            obs_metrics.histogram("elastic.reschedule_s").observe(
                resched_s)

            # checkpoint the live state before touching the execution
            # plan — §6 applies the new plan "immediately after
            # checkpointing", and a failed migration can restore from
            # here
            ckpt_path, ckpt_bytes = self._checkpoint(iteration)

            transition: Dict[str, float] = {}
            if decision.switch:
                transition = trainer.engine.apply_plan(
                    decision.plan, topo=topo,
                    carry_pending=cfg.carry_pending)
                self._cooldown_until = iteration + cfg.cooldown_iters
            else:
                # stay on the incumbent, but predictions must price the
                # drifted environment; when the incumbent no longer fits
                # the drifted device list (no feasible challenger after
                # a drop) the engine keeps the old topology and flags
                # ``topology_stale`` instead of adopting an inconsistent
                # (plan, topo) pair that would crash prediction
                trainer.engine.update_topology(topo)
        rec = AdaptRecord(iteration, decision, decision.switch,
                          trainer.engine.epoch, resched_s,
                          ckpt_path, ckpt_bytes, transition,
                          reactive=reactive)
        self.records.append(rec)
        return rec

    def _reschedule(self, topo: Topology, topo_old: Topology) -> tuple:
        """``reschedule`` onto ``topo``: (topo, decision, seconds).  On
        ranks, rank 0's search and its topology are the world's."""
        trainer, cfg = self.trainer, self.cfg
        t0 = time.monotonic()
        decision = None
        if dist.rank() == 0:
            with obs_trace.span("elastic.reschedule"):
                decision = reschedule(
                    topo, trainer.wf, trainer.plan, budget=cfg.budget,
                    amortization_iters=cfg.amortization_iters,
                    seed=cfg.seed, topo_old=topo_old)
        resched_s = time.monotonic() - t0
        if dist.multi():
            topo, decision, resched_s = dist.broadcast_object(
                (topo, decision, resched_s), 0)
        return topo, decision, resched_s

    def _infer_measured_topology(self) -> Optional[Topology]:
        from repro_torch.obs.calibrate import infer_drifted_topology
        trainer = self.trainer
        if self.monitor is None or self._topo is None:
            return None
        return infer_drifted_topology(self._topo, trainer.wf,
                                      trainer.plan, self.monitor)

    # -- failure escalation ----------------------------------------------
    def handle_failure(self, iteration: int, failure) -> AdaptRecord:
        """Escalate a task failure the retry budget could not absorb:
        drop the devices presumed dead, force a replan onto the
        survivors, checkpoint, and swap.  ``failure`` is the engine's
        ``TaskExecutionError`` (its ``dead_devices`` — or, lacking an
        attribution, the failed task's highest-id device — leave the
        fleet)."""
        dead = list(getattr(failure, "dead_devices", ()) or ())
        if not dead:
            devs = list(getattr(failure, "devices", ()) or ())
            dead = [max(devs)] if devs else []
        if not dead:
            raise ValueError(
                f"cannot escalate {failure!r}: no device attribution")
        trainer, cfg = self.trainer, self.cfg
        base = self._topo if self._topo is not None else trainer.engine.topo
        topo = drop_devices(base, dead)
        obs_metrics.counter("elastic.forced_replans").inc()
        with obs_trace.span("elastic.poll", iteration=iteration,
                            forced=True, dead=str(dead)):
            topo, decision, resched_s = self._reschedule(topo, base)
            ckpt_path, ckpt_bytes = self._checkpoint(iteration)
            # the incumbent references dead devices (old_cost = inf), so
            # any feasible challenger switches; reschedule only declines
            # when the search found no plan that fits the survivors
            if not decision.switch \
                    or not decision.plan.fits_topology(topo):
                raise RuntimeError(
                    f"no feasible plan on the surviving devices "
                    f"(dropped {dead}): {failure}")
            transition = trainer.engine.apply_plan(
                decision.plan, topo=topo, carry_pending=cfg.carry_pending)
        self._topo = topo
        self._observed = topo
        self._cooldown_until = iteration + cfg.cooldown_iters
        rec = AdaptRecord(iteration, decision, True,
                          trainer.engine.epoch, resched_s, ckpt_path,
                          ckpt_bytes, transition, forced=True)
        self.records.append(rec)
        return rec

    @property
    def swaps(self) -> List[AdaptRecord]:
        return [r for r in self.records if r.applied]
