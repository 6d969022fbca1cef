"""The port's partition rules, hints and plan folding against the JAX
package's (``tests/test_sharding.py``), on the CPU with no process world.

Specs are compared as tuples: the port's ``param_tree_specs`` on every
``configs.archs`` smoke and the e2e actor against the reference's on the
same (bridged) parameter trees, ``sanitize_spec`` on meshes (1, 1),
(2, 2), (4, 2) and (8, 1) (a duck mesh with ``axis_names`` and
``devices.shape`` for the reference, so no forced devices are needed).
"""
import dataclasses
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.core import enumerate as jenum, topology as jtopo  # noqa: E402
from repro.core import workflow as jwf  # noqa: E402
from repro.engine import placement as jplace  # noqa: E402
from repro.parallel import sharding as jsh  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import archs as tarchs  # noqa: E402
from repro_torch.core import enumerate as tenum, topology as ttopo  # noqa: E402
from repro_torch.core import workflow as twf  # noqa: E402
from repro_torch.data.synthetic import VOCAB_SIZE  # noqa: E402
from repro_torch.engine import placement as tplace  # noqa: E402
from repro_torch.models import transformer as TT  # noqa: E402
from repro_torch.models.config import ModelConfig  # noqa: E402
from repro_torch.parallel import sharding as sh  # noqa: E402

P = sh.P
E2E = ModelConfig(name="rl-actor", n_layers=4, d_model=192, n_heads=4,
                  n_kv_heads=2, head_dim=48, d_ff=576, vocab_size=16,
                  dtype="float32")
MESHES = [(1, 1), (2, 2), (4, 2), (8, 1)]


def fake_mesh(shape_by_axis):
    """Duck-typed mesh: sanitize_spec only reads axis_names/devices.shape."""
    names = tuple(shape_by_axis)
    return SimpleNamespace(
        axis_names=names,
        devices=np.empty(tuple(shape_by_axis[n] for n in names)))


def _tuples(spec):
    return tuple(tuple(e) if isinstance(e, (tuple, list)) else e
                 for e in spec)


def _jspec_leaves(tree):
    import jax
    return jax.tree_util.tree_leaves(
        tree, is_leaf=lambda s: isinstance(s, JP))


def _spec_pairs(cfg):
    """(port spec, reference spec, shape) for every leaf of ``cfg``'s
    parameter tree (the port's init, bridged to numpy for the
    reference)."""
    cfg = dataclasses.replace(cfg, dtype="float32")
    tp = TT.init_params(cfg, seed=0)
    jp = bridge.to_numpy_params(tp)
    import jax
    jl = jax.tree_util.tree_leaves(jp)
    return list(zip(tplace.spec_leaves(sh.param_tree_specs(tp)),
                    _jspec_leaves(jsh.param_tree_specs(jp)),
                    [np.shape(x) for x in jl]))


ARCH_CFGS = [pytest.param(tarchs.get(n, smoke=True), id=n)
             for n in sorted(tarchs.ARCHS)] + [pytest.param(E2E, id="e2e")]


@pytest.mark.parametrize("cfg", ARCH_CFGS)
def test_param_tree_specs_match_reference(cfg):
    pairs = _spec_pairs(cfg)
    assert pairs
    for t, j, _ in pairs:
        assert _tuples(t) == _tuples(j)


@pytest.mark.parametrize("cfg", ARCH_CFGS)
def test_sanitize_spec_matches_reference(cfg):
    for dp, tp in MESHES:
        mesh = fake_mesh({"data": dp, "model": tp})
        for t, j, shape in _spec_pairs(cfg):
            assert _tuples(sh.sanitize_spec(t, shape, mesh)) == \
                _tuples(jsh.sanitize_spec(j, shape, mesh))


def test_activation_rules_match_reference():
    for seq in (True, False):
        a = sh.default_activation_rules(seq_shard=seq)
        b = jsh.default_activation_rules(seq_shard=seq)
        assert a.keys() == b.keys()
        for k in a:
            assert _tuples(a[k]) == _tuples(b[k]), k


# -- sanitize_spec (tests/test_sharding.py:33-63) ---------------------------

def test_sanitize_spec_non_dividing_axis_replicates():
    mesh = fake_mesh({"data": 4, "model": 2})
    assert sh.sanitize_spec(P("data", "model"), (6, 8), mesh) \
        == P(None, "model")
    assert sh.sanitize_spec(P("data", "model"), (8, 8), mesh) \
        == P("data", "model")


def test_sanitize_spec_tuple_entry_keeps_dividing_prefix():
    mesh = fake_mesh({"data": 4, "model": 2})
    assert sh.sanitize_spec(P(("data", "model"),), (8,), mesh) \
        == P(("data", "model"))
    assert sh.sanitize_spec(P(("data", "model"),), (4,), mesh) == P("data")
    assert sh.sanitize_spec(P(("data", "model"),), (3,), mesh) == P(None)


def test_sanitize_spec_trims_to_rank():
    mesh = fake_mesh({"data": 2, "model": 2})
    assert sh.sanitize_spec(P("data", None, "model"), (4, 4), mesh) \
        == P("data", None)


# -- param_tree_specs (tests/test_sharding.py:70-88) ------------------------

def tiny_cfg():
    return ModelConfig(name="shard-tiny", n_layers=2, d_model=64,
                       n_heads=2, n_kv_heads=2, head_dim=32, d_ff=128,
                       vocab_size=VOCAB_SIZE, dtype="float32")


def test_param_tree_specs_stacked_blocks():
    params = TT.init_params(tiny_cfg())
    specs = sh.param_tree_specs(params)
    flat = {}
    sh.map_with_path(lambda path, leaf: flat.setdefault(
        sh.path_str(path), leaf), params)
    saw_stacked = False
    for path, leaf in flat.items():
        spec = specs
        for k in path.split("/"):
            spec = spec[k]
        assert len(spec) <= leaf.ndim, (path, spec, leaf.shape)
        if path.startswith("blocks/"):
            saw_stacked = True
            assert len(spec) == 0 or spec[0] is None, (path, spec)
    assert saw_stacked
    wq = next(v for k, v in flat.items() if k.endswith("wq"))
    spec = specs["blocks"]["layer0"]["attn"]["wq"]
    assert tuple(spec) == (None, "data", "model") and wq.ndim == 3


def test_placements_and_use_spec():
    mesh = SimpleNamespace(mesh_dim_names=("data", "model"))
    from torch.distributed.tensor import Replicate, Shard
    assert sh.placements(P("data", "model"), mesh) == (Shard(0), Shard(1))
    assert sh.placements(P("model", "data"), mesh) == (Shard(1), Shard(0))
    assert sh.placements(P(None, None), mesh) == (Replicate(), Replicate())
    assert sh.placements(P(("data", "model"),), mesh) == (Shard(0),
                                                         Shard(0))
    # FSDP storage over data, TP use over model
    assert sh.use_spec(P(None, "data", "model")) == P(None, None, "model")
    assert sh.use_spec(P(("data", "model"), None)) == P("model", None)
    # plain trees pass through for_use untouched
    params = TT.init_params(tiny_cfg())
    assert sh.for_use(params) is params


# -- hint (tests/test_sharding.py:115-131) ----------------------------------

def test_hint_identity_outside_rules():
    x = torch.arange(8.0).reshape(2, 4)
    assert sh.hint(x, "residual") is x


def test_hint_identity_for_unknown_name():
    x = torch.arange(4.0)
    with sh.use_hints({"residual": P("data")}):
        assert sh.hint(x, "not-a-rule") is x


def test_hint_identity_on_plain_tensors_inside_rules():
    x = torch.ones(2, 3, 4)
    with sh.use_hints(sh.default_activation_rules(seq_shard=False)):
        assert sh.hint(x, "residual") is x


def test_use_hints_restores_previous_rules():
    with sh.use_hints({"a": P()}):
        with sh.use_hints({"b": P()}):
            assert sh._rules() == {"b": P()}
        assert sh._rules() == {"a": P()}
        x = torch.ones(3)
        assert sh.hint(x, "b") is x
    assert sh._rules() is None


# -- fold_plan / fold_devices / build_placement (tests/test_sharding.py:
#    134-236): the port's on the port's plan, the reference's on its own ----

def _gen_rest_plan(topology, workflow, enum_mod, cfg, n_devices=8):
    topo = topology.build_testbed("single_region",
                                  counts={"A100": n_devices // 2,
                                          "L4": n_devices // 2})
    spec = workflow.LLMSpec.from_model_config(cfg)
    wf = workflow.make_workflow("grpo", spec, synchronous=True,
                                n_rollouts=4, seq_in=8, seq_out=4,
                                global_batch=1)
    grouping = next(g for g in enum_mod.priority_groupings(wf)
                    if len(g) == 2 and any(
                        wf.task(t).kind == workflow.TaskKind.GEN
                        for t in min(g, key=len)))
    sizes = enum_mod.proportional_sizes(wf, grouping, topo.n)
    plan = enum_mod.build_plan(topo, wf, grouping, sizes,
                               list(range(topo.n)))
    return wf, plan


@pytest.fixture(scope="module")
def plans():
    from repro.configs.archs import SMOKE
    jcfg = dataclasses.replace(SMOKE["qwen3-0.6b"], vocab_size=VOCAB_SIZE)
    tcfg = dataclasses.replace(tarchs.SMOKE["qwen3-0.6b"],
                               vocab_size=VOCAB_SIZE)
    return (_gen_rest_plan(jtopo, jwf, jenum, jcfg),
            _gen_rest_plan(ttopo, twf, tenum, tcfg))


def test_fold_plan_injective_when_plan_fits(plans):
    (_, jplan), (_, plan) = plans
    local = [f"dev{i}" for i in range(8)]
    f = tplace.fold_plan(plan, local)
    assert not f.oversubscribed and f.n_collisions == 0
    assert len(set(f.mapping.values())) == len(f.mapping)
    assert f.mapping == {i: i for i in range(8)}
    assert f.mapping == jplace.fold_plan(jplan, local).mapping


def test_fold_plan_disjoint_groups_stay_disjoint(plans):
    _, (_, plan) = plans
    f = tplace.fold_plan(plan, [f"dev{i}" for i in range(8)])
    locals_of = [{f.mapping[int(d)] for d in g.devices} for g in plan.groups]
    assert locals_of[0].isdisjoint(locals_of[1])


def test_fold_plan_rank_maps_sparse_ids(plans):
    _, (_, plan) = plans
    remap = {i: i * 3 + 1 for i in range(8)}
    groups = tuple(dataclasses.replace(
        g, devices=tuple(remap[int(d)] for d in g.devices))
        for g in plan.groups)
    assignment = {t: np.vectorize(remap.get)(a)
                  for t, a in plan.assignment.items()}
    sparse = dataclasses.replace(plan, groups=groups, assignment=assignment)
    f = tplace.fold_plan(sparse, [f"dev{i}" for i in range(8)])
    assert not f.oversubscribed and f.n_collisions == 0
    assert f.mapping == {i * 3 + 1: i for i in range(8)}


def test_fold_plan_oversubscribed_reports_collisions(plans):
    (_, jplan), (_, plan) = plans
    local = ["devA", "devB", "devC"]
    f = tplace.fold_plan(plan, local)
    assert f.oversubscribed and f.n_collisions > 0
    for li, gis in f.collisions:
        assert 0 <= li < 3 and len(gis) >= 2
    assert f.colliding_groups
    f2 = tplace.fold_plan(plan, local)
    assert f2.mapping == f.mapping and f2.collisions == f.collisions
    jf = jplace.fold_plan(jplan, local)
    assert (f.mapping, f.collisions) == (jf.mapping, jf.collisions)


def test_fold_devices_legacy_vs_mapping():
    local = ["devA", "devB", "devC"]
    assert tplace.fold_devices([5, 2], local) == ["devC"]
    assert tplace.fold_devices([5, 2], local, {5: 0, 2: 1}) == \
        ["devA", "devB"]


def test_build_placement_collision_flag(plans):
    (jw, jplan), (wf, plan) = plans
    local = ["devA", "devB", "devC"]
    folding = tplace.fold_plan(plan, local)
    pls = {t: tplace.build_placement(plan, t, local, folding)
           for t in range(wf.n_tasks)}
    jpls = {t: jplace.build_placement(jplan, t, list(range(3)))
            for t in range(jw.n_tasks)}
    assert any(pl.collision for pl in pls.values())
    for t, pl in pls.items():
        assert int(np.prod(pl.mesh_shape)) == len(pl.local_devices)
        assert pl.tp_eff == pl.mesh_shape[1]
        assert (pl.mesh_shape, pl.collision) == \
            (tuple(jpls[t].mesh.devices.shape), jpls[t].collision)
        # plain devices in a world of one rank: no process group to
        # shard over
        if pl.sharded:
            with pytest.raises(RuntimeError, match="one process per"):
                pl.param_shardings({})


def test_build_placement_full_host_no_collision(plans):
    _, (wf, plan) = plans
    from repro_torch.parallel import dist
    local = [dist.RankDevice(r, torch.device("cpu")) for r in range(8)]
    folding = tplace.fold_plan(plan, local)
    pls = {t: tplace.build_placement(plan, t, local, folding)
           for t in range(wf.n_tasks)}
    assert not any(pl.collision for pl in pls.values())
    for pl in pls.values():
        assert pl.ranks == tuple(d.rank for d in pl.local_devices)
        assert pl.lead == pl.ranks[0]
        # this process is rank 0 of a world of one: it runs the tasks
        # that hold rank 0 only, and builds no process group
        assert pl.here == (0 in pl.ranks)
        assert isinstance(pl.mesh, tplace.LocalMesh)
