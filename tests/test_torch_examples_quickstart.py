"""``repro_torch.examples.quickstart`` against ``examples/quickstart.py``
(host only: the scheduler, simulator and baselines on the 64-GPU
multi-country testbed): stdout identical, character for character, at
the script's own settings.  Also: every example module imports no JAX
and nothing of the JAX package, and takes its reference's flags."""
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from torch_examples_ref import REPO, load, run_port, run_ref  # noqa: E402

from repro_torch.examples import quickstart  # noqa: E402

EXAMPLES = ("quickstart", "schedule_heterogeneous", "serve_batched",
            "trace_obs", "train_rl_e2e", "train_rl_elastic")
ON_A_DEVICE = ("serve_batched", "trace_obs", "train_rl_e2e",
               "train_rl_elastic")


def test_quickstart_prints_the_reference_lines(capsys, monkeypatch):
    ref = run_ref(load("quickstart"), [], capsys, monkeypatch)
    out, got = run_port(quickstart, [], capsys)
    assert got == ref
    assert "HetRL plan:" in got and "baselines: verl" in got
    assert out["search"].cost > 0


def test_examples_import_no_jax_and_no_repro():
    """The six modules, each in the walk of ``repro_torch.examples``,
    imported in a fresh interpreter: no ``jax``, no ``repro``."""
    code = ("import importlib, pkgutil, sys\n"
            "import repro_torch.examples as ex\n"
            "mods = sorted(m.name.rsplit('.', 1)[1] for m in "
            "pkgutil.walk_packages(ex.__path__, 'repro_torch.examples.'))\n"
            "for m in mods: importlib.import_module('repro_torch.examples.'"
            " + m)\n"
            "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'repro'))\n"
            "print(mods, bad)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120,
                       env={**os.environ,
                            "PYTHONPATH": os.path.join(REPO, "src")})
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == f"{sorted(EXAMPLES)} []", r.stdout


def _flags(call, monkeypatch):
    """The argparse namespace a ``main`` builds (``call`` runs it): its
    ``parse_args`` is stopped right after it parsed."""
    import argparse

    class Parsed(Exception):
        pass
    seen = {}
    orig = argparse.ArgumentParser.parse_args

    def parse_args(self, args=None, namespace=None):
        seen["ns"] = orig(self, args, namespace)
        raise Parsed
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", parse_args)
    with pytest.raises(Parsed):
        call()
    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", orig)
    return vars(seen["ns"])


@pytest.mark.parametrize("name", EXAMPLES)
def test_examples_take_the_reference_flags_and_defaults(name, monkeypatch):
    """The port's flags and defaults are the reference script's, plus
    ``--device`` (default ``cuda``) on the four that touch a device."""
    import importlib
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    port = _flags(lambda: mod.main([]), monkeypatch)
    monkeypatch.setattr(sys, "argv", [name])
    # quickstart.py and trace_obs.py parse no command line
    ref = {} if name in ("quickstart", "trace_obs") else \
        _flags(load(name).main, monkeypatch)
    if name in ON_A_DEVICE:
        assert port.pop("device") == "cuda"
    assert port == ref


@pytest.mark.parametrize("name", ON_A_DEVICE)
def test_device_examples_refuse_to_run_without_a_card(name, monkeypatch):
    """The default ``--device cuda`` raises without a card; nothing runs
    quietly on the CPU."""
    import importlib
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mod = importlib.import_module(f"repro_torch.examples.{name}")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main([])
