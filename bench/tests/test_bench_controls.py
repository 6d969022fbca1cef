"""Each cell's control, the reference in the next lower precision put in
the program's place, comes out not correct under the cell's limits: fp8
for the serving cells (on the CPU, at the small size and its limits),
TF32 for the float32 RL cell (on the card only: TF32 does nothing on the
CPU).  At the cells' own sizes the controls were run on the card
(``bench/calibrate.py``; readings in PERF.md)."""
import pytest
import torch

from bench.tests import smallcells
from bench.harness import spec


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return smallcells.make_root(tmp_path_factory.mktemp("controls"))


def readings(root, workload, device, seed, prec):
    cell = spec.load_cell(workload, root=root)
    drv = spec.driver(cell).Driver(cell, seed, device, spec.family(cell),
                                   spec.reference(cell))
    drv.setup()
    units = [drv.unit(drv.first_unit)]
    drv.free()
    return cell.limits, drv.readings(units), drv.readings(units, prec)


def failed(limits, numbers):
    return sorted(k for k, v in numbers.items() if v > limits[k])


@pytest.mark.parametrize("workload", ["qwen3-0.6b.gen_decode",
                                      "rwkv6-3b.gen_prefill"])
def test_fp8_control_is_not_correct(root, workload):
    limits, program, control = readings(root, workload, torch.device("cpu"),
                                        2**31 + 17, "fp8")
    assert failed(limits, program) == []
    assert "max_logprob_gap" in failed(limits, control)


@pytest.mark.cuda
def test_tf32_control_is_not_correct(root):
    if not torch.cuda.is_available():
        pytest.skip("TF32 exists only on the card")
    limits, program, control = readings(root, "qwen3-0.6b.rl_grpo",
                                        torch.device("cuda", 0), 2**31 + 17,
                                        "tf32")
    assert failed(limits, program) == []
    assert failed(limits, control)
