"""``repro_torch.examples.schedule_heterogeneous`` against
``examples/schedule_heterogeneous.py`` (host only): stdout identical,
character for character, at a reduced budget substituted alike in both
modules.  At ``--fast`` the reference takes about three minutes on a CPU
(eleven SHA-EA searches and a 60 s wall-clock ILP), so here each
``HybridScheduler`` searches at most ``GROUPINGS`` task groupings of at
most ``SIZES`` group sizes each on a budget of at most ``BUDGET``
evaluations, and ``ilp_scheduler`` runs on
a node budget in place of its wall clock (a wall clock would make the
optimum depend on the host's speed)."""
import pytest

torch = pytest.importorskip("torch")

from torch_examples_ref import load, run_port, run_ref  # noqa: E402

from repro_torch.examples import schedule_heterogeneous  # noqa: E402

GROUPINGS, SIZES, BUDGET, ILP_NODES = 2, 1, 25, 500


def _capped(mod, monkeypatch):
    """Cap ``mod``'s ``HybridScheduler`` and ``ilp_scheduler``."""
    hs, ilp = mod.HybridScheduler, mod.ilp_scheduler

    class Capped(hs):
        def __init__(self, topo, wf, *, max_groupings,
                     max_sizes_per_grouping):
            super().__init__(
                topo, wf, max_groupings=min(max_groupings, GROUPINGS),
                max_sizes_per_grouping=min(max_sizes_per_grouping, SIZES))

        def search(self, budget, *a, **k):
            return super().search(min(budget, BUDGET), *a, **k)

    def by_nodes(topo, wf, *, max_seconds):
        assert max_seconds == 60
        return ilp(topo, wf, max_seconds=1e9, max_nodes=ILP_NODES)
    monkeypatch.setattr(mod, "HybridScheduler", Capped)
    monkeypatch.setattr(mod, "ilp_scheduler", by_nodes)


def test_schedule_heterogeneous_prints_the_reference_lines(capsys,
                                                           monkeypatch):
    ref_mod = load("schedule_heterogeneous")
    _capped(ref_mod, monkeypatch)
    _capped(schedule_heterogeneous, monkeypatch)
    ref = run_ref(ref_mod, ["--fast"], capsys, monkeypatch)
    out, got = run_port(schedule_heterogeneous, ["--fast"], capsys)
    assert got == ref
    lines = got.splitlines()
    assert len([ln for ln in lines if ln.startswith(
        ("single_region", "multi_region", "multi_country",
         "multi_continent"))]) == 4
    assert any(ln.startswith("TPU pool") for ln in lines)
    assert any(ln.startswith("8-GPU exact ILP optimum") for ln in lines)
    assert out["ilp"].evals <= ILP_NODES + 10
