"""The JAX package's example scripts (``examples/<name>.py``) loaded and
run in the test's process on the CPU, their stdout captured: what
``tests/test_torch_examples*.py`` hold the port's examples
(``repro_torch.examples``) against.

A script is loaded from its file under a module name of its own, so the
tests can substitute names in it with ``monkeypatch`` as they do in the
port's module; the ``sys.path`` entry it adds at import is taken back.
"""
import importlib.util
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name: str):
    """``examples/<name>.py`` as a fresh module ``ref_examples_<name>``."""
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"ref_examples_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    saved = list(sys.path)
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = saved
    return mod


def run_ref(mod, argv, capsys, monkeypatch) -> str:
    """The reference script's ``main()`` with ``argv`` as its command
    line; returns what it printed."""
    monkeypatch.setattr(sys, "argv", [mod.__file__] + list(argv))
    capsys.readouterr()
    mod.main()
    return capsys.readouterr().out


def run_port(mod, argv, capsys):
    """The port's ``main(argv)``: (what it returned, what it printed)."""
    capsys.readouterr()
    out = mod.main(list(argv))
    return out, capsys.readouterr().out


def recording_trainer(cls, into: dict):
    """A subclass of the reference's ``RLTrainer`` that keeps, as numpy,
    its initial ``state_tree()`` (``into["state"]``) and every
    iteration's metrics (``into["metrics"]``)."""
    import jax

    class Recording(cls):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            into["state"] = jax.tree_util.tree_map(np.asarray,
                                                   self.state_tree())
            into["metrics"] = []

        def iteration(self, *a, **k):
            m = super().iteration(*a, **k)
            into["metrics"].append(dict(m))
            return m
    return Recording


def bridged_trainer(cls, into: dict):
    """A subclass of the port's ``RLTrainer`` that starts from the state
    a ``recording_trainer`` kept (``into["state"]``), bridged."""
    from repro_torch import bridge

    class Bridged(cls):
        def __init__(self, cfg, *a, **k):
            super().__init__(cfg, *a, **k)
            self.load_state_tree(bridge.from_numpy_state_tree(
                into["state"], cfg, self.device))
    return Bridged
