"""The RL launcher's fault scenarios on 8 gloo ranks, against the port's
world of one and the JAX launcher.

``launch.train --rl grpo --smoke --batch 4 --search-budget 16 --steps 8
--fault <scenario> --require-recover`` runs on 8 CPU ranks
(``tests/torch_sharded_ranks.py``: one spawned world, the scenarios one
after the other, each in a working directory of its own) while this
process runs the same command in a world of one and through the JAX
launcher.  The searched plan puts GEN, reward and reference inference
on ranks 1-7 (DP 7) and actor training on rank 0.

Held for each of transient_crash, permanent_crash, ckpt_corrupt,
slot_failure and link_throttle: every rank ends the run alike ("done"),
rank 0 alone prints, and rank 0's ``faults:`` line, recovery kind and
``TASK FAILURE`` iterations are the world of one's and the reference's;
against the world of one, the rewards equal and the KL within 2e-3 (the
bounds of ``test_rl_launcher_under_torchrun``) up to the first replan or
failure, and for permanent_crash the forced replan (its iteration,
epoch and plan) and the declared one after it.  Not held: the iteration
of a reactive replan (the divergence monitor reads measured time; in
these runs it fires at iteration 4 on ranks and in the world of one
alike for transient_crash), sampled tokens after a replan.

Then the executor on ranks (``overlapped_failure``): ``sharded_exec``'s
async trainer, whose GEN ranks decode while the other ranks train (the
overlapped walk), with a permanent crash of actor_training in its first
trained iteration: every rank raises the world of one's
``TaskExecutionError``, none hangs, and after the forced replan onto 7
plan devices the rank left without a placement runs no task, holds no
state and still takes part in the next iteration, and in a swap to the
same plan (where the sharded states redistribute on their own meshes).
"""
import re
import sys

import pytest

torch = pytest.importorskip("torch")

from repro.launch import train as jlaunch  # noqa: E402
from repro.obs import metrics as jmetrics  # noqa: E402
from repro_torch.launch import sharded_exec  # noqa: E402
from repro_torch.launch import train as tlaunch  # noqa: E402
from repro_torch.obs import metrics as tmetrics  # noqa: E402

from test_torch_sharded import start_world  # noqa: E402

ARGV = ["--arch", "qwen3-0.6b", "--smoke", "--rl", "grpo", "--steps", "8",
        "--batch", "4", "--search-budget", "16", "--require-recover"]
SCENARIOS = ["transient_crash", "permanent_crash", "ckpt_corrupt",
             "slot_failure", "link_throttle"]
KL_TOL = 2e-3


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("faults_ranks")
    job = {"kind": "launch", "world": 8, "timeout": 420,
           "cwd": str(tmp / "ranks"),
           "runs": [(f, ARGV + ["--fault", f, "--device", "cpu"])
                    for f in SCENARIOS],
           "extras": ("overlapped_failure",),
           "cfg": sharded_exec.tiny_cfg(), "batch": 4, "budget": 16}
    w = start_world(job, tmp, timeout=480)
    yield w
    w.stop()


# ---------------------------------------------------------------------------
# the launcher's lines, in three worlds
# ---------------------------------------------------------------------------

def run_reference(flags, capsys, monkeypatch, cwd):
    """The JAX launcher in ``cwd``: its printed lines."""
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    jmetrics.reset()
    monkeypatch.setattr(sys, "argv", ["train"] + ARGV + flags)
    jlaunch.main()
    return capsys.readouterr().out.splitlines()


def run_port(flags, capsys, monkeypatch, cwd):
    """The port's launcher in a world of one in ``cwd``: its lines and
    result."""
    cwd.mkdir()
    monkeypatch.chdir(cwd)
    capsys.readouterr()
    tmetrics.reset()
    out = tlaunch.main(ARGV + flags + ["--device", "cpu"])
    return capsys.readouterr().out.splitlines(), out


def recovery_kind(lines):
    rec = [ln for ln in lines if ln.startswith("recovered:")]
    assert len(rec) == 1, lines
    return re.sub(r"\d+", "N", rec[0])


def failures(lines):
    return [ln.split(":")[0] for ln in lines if "TASK FAILURE" in ln]


def first_reaction(lines) -> int:
    """The iteration of the first replan or task failure (the steps when
    there is none)."""
    last = -1
    for ln in lines:
        if ln.startswith("iter "):
            last = int(ln.split()[1])
            if "TASK FAILURE" in ln:
                return last
        elif ln.lstrip().startswith("drift"):
            return last
    return 1 << 30


def iters(lines, before: int):
    """(iteration, reward, kl) of the iterations before ``before``."""
    out = []
    for ln in lines:
        f = ln.split()
        if ln.startswith("iter ") and f[2].startswith("reward="):
            it = int(f[1])
            if it < before:
                out.append((it, f[2], float(f[3][len("kl="):])))
    return out


def hold(ranks, w1, ref, *, declared: bool):
    """A launcher run on ranks (every rank's ``launch_runs`` record)
    against the world of one's (lines, result) and the reference's
    lines.  ``declared``: the run's non-reactive replans (a declared
    drift, a forced replan) are held too."""
    lines = ranks[0]["lines"]
    tl, out = w1
    assert [r["outcome"] for r in ranks] == ["done"] * len(ranks), \
        [r["outcome"] for r in ranks]
    assert all(r["lines"] == [] for r in ranks[1:])   # rank 0 alone prints
    assert lines[-1] == tl[-1] == ref[-1] == "done"
    assert sum(ln.startswith("plan: ") for ln in lines) == 1
    assert [ln for ln in lines if ln.startswith("faults:")] == \
        [ln for ln in tl if ln.startswith("faults:")] == \
        [ln for ln in ref if ln.startswith("faults:")]
    if any(ln.startswith("faults:") for ln in lines):
        assert recovery_kind(lines) == recovery_kind(tl) == \
            recovery_kind(ref)
        assert out["recovered"] in tl
    assert failures(lines) == failures(tl) == failures(ref)
    # every rank took the same reactions
    assert all(r["records"] == ranks[0]["records"] for r in ranks)
    first = min(first_reaction(lines), first_reaction(tl))
    got, want = iters(lines, first), iters(tl, first)
    assert got and len(got) == len(want), (got, want)
    for g, w in zip(got, want):
        assert g[:2] == w[:2]                   # iteration, reward
        assert abs(g[2] - w[2]) < KL_TOL
    if declared:
        from torch_sharded_ranks import records
        mine = [r for r in ranks[0]["records"] if not r["reactive"]]
        theirs = [r for r in records(out["controller"]) if not r["reactive"]]
        assert mine and mine == theirs


@pytest.mark.parametrize("scenario", SCENARIOS)
def test_launcher_fault_on_ranks_like_world_of_one_and_reference(
        scenario, world, capsys, monkeypatch, tmp_path):
    flags = ["--fault", scenario]
    ref = run_reference(flags, capsys, monkeypatch, tmp_path / "ref")
    w1 = run_port(flags, capsys, monkeypatch, tmp_path / "port")
    res = world.result()
    ranks = [r["runs"][scenario] for r in res["ranks"]]
    hold(ranks, w1, ref, declared=scenario == "permanent_crash")


# ---------------------------------------------------------------------------
# the executor: a failure reaches every rank
# ---------------------------------------------------------------------------

def test_overlapped_walk_failure_raises_alike_on_every_rank(world):
    """TRAIN fails permanently on ranks 4-7 while ranks 0-3 wait in the
    GEN exchange: all 8 raise the world of one's error (whose stage walk
    is serial), log the world's fault events, and take the same forced
    replan, after which the iteration trains."""
    res = world.result()
    outs = [r["overlapped_failure"] for r in res["ranks"]]
    one = res["world1"]["overlapped_failure"]
    assert all(o["overlap"] for o in outs) and not one["overlap"]
    err = outs[0]["error"]
    assert err is not None and err["permanent"]
    assert all(o["error"] == err for o in outs)
    assert err == one["error"]
    assert "actor_training" in err["text"]
    assert all(o["log"] == one["log"] for o in outs)
    assert all(o["plan"] == one["plan"] for o in outs)
    assert all(o["after_loss"] == outs[0]["after_loss"] for o in outs)
    assert outs[0]["after_loss"] is not None


def test_ranks_without_a_placement_take_part_and_hold_no_state(world):
    """After the forced replan the plan has 7 devices for 8 ranks: the
    rank it leaves out runs no task and holds no state, yet it joined
    every collective of the swap and of the next iteration (which ended
    on every rank)."""
    res = world.result()
    outs = [r["overlapped_failure"] for r in res["ranks"]]
    used = {r for ranks in outs[0]["placed"].values() for r in ranks}
    idle = [i for i, o in enumerate(outs) if not o["runs_a_task"]]
    assert idle and len(used) == 7
    for i in idle:
        assert i not in used and outs[i]["holds"] == []
    # then a swap to the same plan: the sharded states redistribute on
    # their own meshes and the idle rank skips them; one more iteration
    one = res["world1"]["overlapped_failure"]
    assert all(o["kept_loss"] == outs[0]["kept_loss"] for o in outs)
    assert outs[0]["kept_loss"] is not None and one["kept_loss"] is not None
