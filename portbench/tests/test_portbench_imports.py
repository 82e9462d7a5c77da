"""What the benchmark's sources import: nothing of JAX or the JAX
package anywhere, nothing of the port under reference/; and the run's
own guard compares top-level names whole."""
import ast
import os

import pytest

from portbench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "lightgbm_tpu"}


def sources(sub=""):
    root = os.path.join(run.BENCH_DIR, sub)
    for dirpath, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, run.BENCH_DIR))
def test_no_jax_anywhere(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, run.BENCH_DIR))
def test_reference_imports_nothing_of_the_port(path):
    names = set(top_level_imports(path))
    assert "lightgbm_tpu_torch" not in names
    # importlib: reference/objectives finds a module of its own by name
    assert names <= {"__future__", "typing", "importlib", "numpy", "torch"}


def test_guard_compares_whole_names():
    assert run.forbidden_loaded(["lightgbm_tpu_torch", "lightgbm_tpu_torch.ops",
                                 "jaxtyping", "numpy"]) == []
    assert run.forbidden_loaded(["lightgbm_tpu.models", "jax._src.core",
                                 "flax"]) == ["flax", "jax", "lightgbm_tpu"]


def test_objectives_load_only_their_own_modules():
    from portbench.reference import objectives
    for name in ("binary", "lambdarank"):
        mod = objectives.load(name)
        assert mod.__name__ == objectives.__name__ + "." + name
        assert callable(mod.make) and callable(mod.pairs)
