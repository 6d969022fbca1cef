"""The port's exact optimiser and baseline schedulers
(``repro_torch.core.ilp``, ``repro_torch.core.baselines``) against the
JAX package's: at the same seed and node or evaluation budget each
returns the reference's plan (grouping, group sizes, devices,
parallelisations, tasklet orders) and cost.  Budgets are node or
evaluation counts; every ILP call passes ``max_seconds=1e9``, so no wall
clock decides a result."""
import math

import numpy as np
import pytest

pytest.importorskip("torch")

from repro.core import baselines as jbase  # noqa: E402
from repro.core import topology as jtopo, workflow as jwf  # noqa: E402
from repro.core.ilp import ilp_scheduler as jilp  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import topology as ttopo, workflow as twf  # noqa: E402
from repro_torch.core.ilp import ilp_scheduler as tilp  # noqa: E402


def _assert_same(tr, jr, *, rel=0.0):
    assert (tr.plan is None) == (jr.plan is None)
    if rel:
        assert math.isclose(tr.cost, jr.cost, rel_tol=rel)
    else:
        assert tr.cost == jr.cost
    assert tr.evals == jr.evals
    assert tr.grouping == jr.grouping
    assert (None if tr.sizes is None else tuple(tr.sizes)) == \
        (None if jr.sizes is None else tuple(jr.sizes))
    if jr.plan is None:
        return
    jp, tp = jr.plan, tr.plan
    assert dict(tp.parallel) == dict(jp.parallel)
    assert set(tp.assignment) == set(jp.assignment)
    for t in jp.assignment:
        np.testing.assert_array_equal(np.asarray(tp.assignment[t]),
                                      np.asarray(jp.assignment[t]))
    assert [g.devices for g in tp.groups] == [g.devices for g in jp.groups]
    assert [g.tasks for g in tp.groups] == [g.tasks for g in jp.groups]


def _small(topo_m, wf_m, n_a100=2, n_l4=2):
    topo = topo_m.build_testbed("single_region",
                                counts={"A100": n_a100, "L4": n_l4})
    return topo, wf_m.make_grpo(wf_m.QWEN_1_7B, global_batch=64)


def _big(topo_m, wf_m):
    return (topo_m.build_testbed("multi_country"),
            wf_m.make_ppo(wf_m.QWEN_8B))


@pytest.mark.parametrize("max_nodes", [2000, 20_000])
def test_ilp_returns_the_reference_plan_and_cost(max_nodes):
    jr = jilp(*_small(jtopo, jwf), max_seconds=1e9, max_nodes=max_nodes)
    tr = tilp(*_small(ttopo, twf), max_seconds=1e9, max_nodes=max_nodes)
    assert jr.plan is not None
    _assert_same(tr, jr, rel=1e-9)


def test_verl_returns_the_reference_plan_and_cost():
    _assert_same(tbase.verl_scheduler(*_big(ttopo, twf)),
                 jbase.verl_scheduler(*_big(jtopo, jwf)))


def test_streamrl_returns_the_reference_plan_and_cost():
    _assert_same(tbase.streamrl_scheduler(*_big(ttopo, twf), budget=512),
                 jbase.streamrl_scheduler(*_big(jtopo, jwf), budget=512))


def test_deap_returns_the_reference_plan_and_cost():
    _assert_same(tbase.deap_scheduler(*_big(ttopo, twf), budget=60, seed=3),
                 jbase.deap_scheduler(*_big(jtopo, jwf), budget=60, seed=3))


def test_pure_sha_returns_the_reference_plan_and_cost():
    """The samplers' seeds hash each (grouping, sizes) key: tuples of
    ints hash alike in every process, so both packages draw alike."""
    tr = tbase.pure_sha_scheduler(*_small(ttopo, twf, 4, 4), budget=40,
                                  seed=1)
    jr = jbase.pure_sha_scheduler(*_small(jtopo, jwf, 4, 4), budget=40,
                                  seed=1)
    assert math.isfinite(jr.cost)
    _assert_same(tr, jr)


def test_pure_ea_never_runs_a_local_search(monkeypatch):
    """PureEA's ``local_search`` hands the individual back: the base
    class's search (the Baldwinian step) never runs, and the run is the
    reference's evaluation for evaluation."""
    from repro_torch.core.ea import EvolutionarySearch
    calls = []
    base = EvolutionarySearch.local_search
    monkeypatch.setattr(EvolutionarySearch, "local_search",
                        lambda self, ind, max_steps=20:
                        calls.append(ind) or base(self, ind, max_steps))
    runs = []
    for topo_m, wf_m, base_m in ((ttopo, twf, tbase), (jtopo, jwf, jbase)):
        topo, wf = _big(topo_m, wf_m)
        grouping = base_m.enum_mod.task_groupings(wf)[2]
        sizes = base_m.enum_mod.proportional_sizes(wf, grouping, topo.n)
        ea = base_m.PureEA(topo, wf, grouping, sizes, seed=0)
        assert ea.mutate_upgrade_p == 0.0 and not ea.use_load_balance
        runs.append(ea.run(30)[1])
        ind = ea._random_individual()
        assert ea.local_search(ind, max_steps=50) is ind
    assert not calls
    assert math.isfinite(runs[0]) and runs[0] == runs[1]
