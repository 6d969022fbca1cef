"""Nothing under bench/ imports JAX or the JAX package (top-level names
compared whole: ``repro_torch`` is not ``repro``) or reads the JAX-era
``benchmarks/``; the references import nothing of the port."""
import ast
from pathlib import Path

from bench.tests.smallcells import ROOT

BENCH = ROOT / "bench"
JAX = {"jax", "jaxlib", "flax", "repro", "benchmarks"}


def imported(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(
                node.args[0], ast.Constant):
            yield node.args[0].value


def test_no_jax_anywhere_under_bench():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in imported(path)}
        assert not tops & JAX, (path, tops & JAX)
        assert "benchmarks/" not in path.read_text() or path.name == \
            Path(__file__).name


def test_references_import_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        for m in imported(path):
            assert m.split(".")[0] in ("torch", "math", "__future__",
                                       "bench"), (path, m)
            if m.startswith("bench"):
                assert m.startswith("bench.reference"), (path, m)


def test_the_check_of_loaded_modules():
    from bench.harness import cli
    assert cli.forbidden_modules(["repro_torch.models", "reprox", "torch",
                                  "jaxtyping"]) == []
    assert cli.forbidden_modules(["jax.numpy", "repro.models.attention",
                                  "flax", "repro_torch"]) == [
        "flax", "jax", "repro"]
