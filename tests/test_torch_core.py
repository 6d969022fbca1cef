"""The port's copies of the scheduler (``repro_torch.core``) against the
JAX package's: at the same seed and evaluation budget the search returns
the same plan and cost (equality: both are the same numpy code), and the
constraint check, the simulator, the cost model and the engine's device
folding agree exactly on the searched plans.  Budgets are evaluation
counts, never wall-clock seconds."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import costmodel as jcm, simulator as jsim  # noqa: E402
from repro.core import topology as jtopo, workflow as jwf  # noqa: E402
from repro.core.plan import check_constraints as jcheck  # noqa: E402
from repro.core.sha import HybridScheduler as JHS  # noqa: E402
from repro.data.synthetic import AdditionTask as JTask  # noqa: E402
from repro.data.synthetic import PromptDataset as JPrompts  # noqa: E402
from repro.engine import placement as jplace  # noqa: E402
from repro.models.config import ModelConfig as JMC  # noqa: E402
from repro_torch.core import costmodel as tcm, simulator as tsim  # noqa: E402
from repro_torch.core import topology as ttopo, workflow as twf  # noqa: E402
from repro_torch.core.plan import check_constraints as tcheck  # noqa: E402
from repro_torch.core.sha import HybridScheduler as THS  # noqa: E402
from repro_torch.data import synthetic as tsyn  # noqa: E402
from repro_torch.engine import placement as tplace  # noqa: E402
from repro_torch.models.config import ModelConfig as TMC  # noqa: E402

BUDGET = 24


def _e2e(MC):
    """``examples/train_rl_e2e.py``'s actor: d 192, 4 layers, hd 48, 4
    query heads over 2 KV heads, fp32, the task's 16-token vocabulary."""
    return MC(name="rl-actor", n_layers=4, d_model=192, n_heads=4,
              n_kv_heads=2, head_dim=48, d_ff=576, vocab_size=16,
              dtype="float32")


def _search(topo_m, wf_m, HS, MC, alg):
    topo = topo_m.build_testbed("single_region", counts={"A100": 4, "L4": 4})
    wf = wf_m.make_workflow(alg, wf_m.LLMSpec.from_model_config(_e2e(MC)),
                            synchronous=True, global_batch=16, n_rollouts=8,
                            seq_in=5, seq_out=3)
    r = HS(topo, wf, max_groupings=8, max_sizes_per_grouping=4).search(
        budget=BUDGET)
    return topo, wf, r


@pytest.fixture(scope="module", params=["grpo", "ppo"])
def searched(request):
    alg = request.param
    return (_search(jtopo, jwf, JHS, JMC, alg),
            _search(ttopo, twf, THS, TMC, alg))


def test_search_returns_the_same_plan_and_cost(searched):
    (_, _, jr), (_, _, tr) = searched
    assert tr.grouping == jr.grouping
    assert tuple(tr.sizes) == tuple(jr.sizes)
    assert tr.cost == jr.cost
    assert tr.evals == jr.evals
    jp, tp = jr.plan, tr.plan
    assert dict(tp.parallel) == dict(jp.parallel)
    assert set(tp.assignment) == set(jp.assignment)
    for t in jp.assignment:
        np.testing.assert_array_equal(np.asarray(tp.assignment[t]),
                                      np.asarray(jp.assignment[t]))
    assert [g.devices for g in tp.groups] == [g.devices for g in jp.groups]
    assert [g.tasks for g in tp.groups] == [g.tasks for g in jp.groups]


def test_constraints_simulator_and_cost_model_agree(searched):
    (jt, jw, jr), (tt, tw, tr) = searched
    assert tcheck(tt, tw, tr.plan) == jcheck(jt, jw, jr.plan)
    js = jsim.simulate(jt, jw, jr.plan, n_iterations=4)
    ts = tsim.simulate(tt, tw, tr.plan, n_iterations=4)
    assert ts.iteration_time == js.iteration_time
    assert ts.makespan == js.makespan
    assert ts.throughput == js.throughput
    assert [(e.time, e.kind, e.iteration, e.task) for e in ts.timeline] == \
        [(e.time, e.kind, e.iteration, e.task) for e in js.timeline]
    jc, tc = jcm.CostModel(jt, jw), tcm.CostModel(tt, tw)
    assert tc.iteration_cost(tr.plan) == jc.iteration_cost(jr.plan)
    for t in range(jw.n_tasks):
        assert dataclasses.asdict(tc.task_cost(tr.plan, t)) == \
            dataclasses.asdict(jc.task_cost(jr.plan, t))


@pytest.mark.parametrize("n_local", [1, 8])
def test_fold_plan_matches_reference(searched, n_local):
    """Folding onto 1 card (every group collides) and onto 8 stand-in
    devices (injective): the same mapping and collision report; on one
    device the placements' mesh shape, realized tp/dp, representative
    plan ids and collision flags agree too."""
    (_, jw, jr), (_, tw, tr) = searched
    jf = jplace.fold_plan(jr.plan, list(range(n_local)))
    tf = tplace.fold_plan(tr.plan, list(range(n_local)))
    assert tf.mapping == jf.mapping
    assert tf.oversubscribed == jf.oversubscribed
    assert tf.collisions == jf.collisions
    assert tf.colliding_groups == jf.colliding_groups
    if n_local == 1:
        n_groups = len(tr.plan.groups)
        assert tf.n_collisions == int(n_groups > 1)
        assert tf.colliding_groups == (frozenset(range(n_groups))
                                       if n_groups > 1 else frozenset())
        jpl = jplace.build_placements(jr.plan, range(jw.n_tasks),
                                      jax.devices()[:1])
        tpl = tplace.build_placements(tr.plan, range(tw.n_tasks),
                                      [torch.device("cpu")])
        for t in range(jw.n_tasks):
            a, b = tpl[t], jpl[t]
            assert (a.mesh_shape, a.tp_eff, a.dp_eff, a.rep_plan_devices,
                    a.collision, a.sharded) == \
                (b.mesh_shape, b.tp_eff, b.dp_eff, b.rep_plan_devices,
                 b.collision, b.sharded)
            with a.mesh:                   # a no-op context on one device
                pass
    else:
        devs = [torch.device("cpu", i) for i in range(n_local)]
        tpl = tplace.build_placements(tr.plan, range(tw.n_tasks), devs)
        wide = [p for p in tpl.values() if p.sharded]
        assert wide, "the searched plan spreads no task over two devices"
        # plain devices in a world of one rank: sharding runs one
        # process per device (tests/test_torch_sharded.py)
        with pytest.raises(RuntimeError, match="one process per device"):
            wide[0].param_shardings({})


def test_prompts_from_the_same_seed_are_identical():
    jt, tt = JTask(max_operand=9), tsyn.AdditionTask(max_operand=9)
    assert (tt.prompt_len, tt.max_answer_len) == (jt.prompt_len,
                                                  jt.max_answer_len)
    ji = iter(JPrompts(jt, batch=16, seed=1))
    ti = iter(tsyn.PromptDataset(tt, batch=16, seed=1))
    for _ in range(3):
        (jp, ja), (tp, ta) = next(ji), next(ti)
        np.testing.assert_array_equal(tp, jp)
        np.testing.assert_array_equal(ta, ja)
        gen = np.random.default_rng(2).integers(0, 16, (16, 3))
        np.testing.assert_array_equal(tt.reward_batch(ta, gen),
                                      jt.reward_batch(ja, gen))
