"""The RL launcher's declared drift, its checkpoints and a GEN-moving
swap on 8 gloo ranks, against the port's world of one and the JAX
package.

``launch.train --rl grpo --smoke --batch 4 --search-budget 16 --steps 8
--drift drop_tail`` runs on 8 CPU ranks (``tests/torch_sharded_ranks.py``,
one spawned world) while this process runs it in a world of one and
through the JAX launcher.  Held as ``test_torch_faults_ranks.hold``
holds the fault scenarios, plus the declared drift's swap: its
iteration, epoch and plan, and its ``drift:`` line, equal the world of
one's; two epochs.

After the swap the ranks checkpoint (rank 0 writes the state gathered
from its owners' ranks): the file loads in the JAX package
(``repro.checkpoint.io.restore``) with every leaf equal, bit for bit, to
the gathered state, and its bytes are those the port writes in a world
of one for that tree.  Two greedy iterations follow, then the file is
restored on the ranks (rank 0 reads, each owner takes its keys) and the
same two iterations give the same tokens; the state gathered after the
restore equals the file's.

``gen_swap``: ``sharded_exec``'s greedy async trainer (GEN on ranks
0-3 at DP 2 / TP 2) takes a forced replan that drops a GEN plan device
after two iterations; GEN moves to other ranks, and the tokens of the
two iterations before and the two after are the world of one's.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.checkpoint import io as jio  # noqa: E402
from repro_torch.checkpoint import io as tio  # noqa: E402
from repro_torch.launch import sharded_exec  # noqa: E402

from test_torch_faults_ranks import (ARGV, hold, run_port,  # noqa: E402
                                     run_reference)
from test_torch_sharded import start_world  # noqa: E402

STEPS, BATCH = 8, 4


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic_ranks")
    job = {"kind": "launch", "world": 8, "timeout": 300,
           "cwd": str(tmp / "ranks"),
           "runs": [("drop_tail", ARGV + ["--drift", "drop_tail",
                                          "--device", "cpu"])],
           "ckpt": "drop_tail", "steps": STEPS, "batch": BATCH,
           "extras": ("gen_swap",), "cfg": sharded_exec.tiny_cfg(),
           "budget": 16}
    w = start_world(job, tmp, timeout=360)
    yield w, job
    w.stop()


def test_drop_tail_on_ranks_like_world_of_one_and_reference(
        world, capsys, monkeypatch, tmp_path):
    flags = ["--drift", "drop_tail"]
    ref = run_reference(flags, capsys, monkeypatch, tmp_path / "ref")
    w1 = run_port(flags, capsys, monkeypatch, tmp_path / "port")
    res = world[0].result()
    ranks = [r["runs"]["drop_tail"] for r in res["ranks"]]
    hold(ranks, w1, ref, declared=True)

    def drift(lines):
        return [ln.split(" in ")[0] + ln.split("s -> ")[1] for ln in lines
                if ln.lstrip().startswith("drift")]
    lines, tl = ranks[0]["lines"], w1[0]
    assert drift(lines) == drift(tl) and len(drift(lines)) == 1
    assert "switch=True" in drift(lines)[0]
    assert [ln.split(":")[0] for ln in lines if ln.startswith("epoch ")] \
        == ["epoch 0", "epoch 1"]


def test_checkpoint_written_on_ranks_loads_in_the_jax_package(world,
                                                               tmp_path):
    res, job = world[0].result(), world[1]
    ck = res["ranks"][0]["ckpt"]
    path = os.path.join(job["cwd"], "drop_tail", ck["path"])
    state = ck["state"]
    got = jio.restore(path, state)
    flat_w = jax_leaves(state)
    flat_g = jax_leaves(got)
    assert len(flat_g) == len(flat_w) > 0
    for g, w in zip(flat_g, flat_w):
        g = np.asarray(g)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    # the world of one's writer, given the gathered tree
    one = tmp_path / "world1.msgpack"
    tree = tio_tree(state)
    assert tio.save(str(one), tree) == ck["bytes"] == os.path.getsize(path)
    with open(path, "rb") as f, open(one, "rb") as g:
        assert f.read() == g.read()


def test_restore_on_ranks_reowns_the_state(world):
    """Every rank's tokens after the restore are those of the run that
    went on without it; the gathered state after the restore is the
    file's; the ranks hold the keys the swap gave them."""
    res = world[0].result()
    for r in res["ranks"]:
        ck = r["ckpt"]
        a, b = ck["tokens"][:2], ck["tokens"][2:]
        assert len(a) == len(b) == 2
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        assert ck["holds"] == r["runs"]["drop_tail"]["holds"]
    ck = res["ranks"][0]["ckpt"]
    for x, y in zip(jax_leaves(ck["state"]), jax_leaves(ck["restored"])):
        assert x.tobytes() == y.tobytes()
    # the swap onto fewer devices left ranks without state, and they
    # took part in the restore
    assert any(r["ckpt"]["holds"] == [] for r in res["ranks"])


def test_swap_that_moves_gen_keeps_its_tokens(world):
    res = world[0].result()
    outs = [r["gen_swap"] for r in res["ranks"]]
    one = res["world1"]["gen_swap"]
    s = outs[0]
    assert s["before"][0] == [0, 1, 2, 3] and s["before"][1] == [2, 2]
    assert s["after"][0] != s["before"][0]            # GEN moved
    assert all(o["plan"] == one["plan"] == s["plan"] for o in outs)
    assert s["epoch"] == one["epoch"] == 1
    assert len(s["tokens"]) == len(one["tokens"]) == 4
    for o in outs:
        for x, y in zip(o["tokens"], one["tokens"]):
            if y is None:
                assert x is None
            else:
                np.testing.assert_array_equal(x, y)


def jax_leaves(tree):
    import jax
    return jax.tree_util.tree_leaves(tree)


def tio_tree(state):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: torch.as_tensor(np.asarray(x)), state)
