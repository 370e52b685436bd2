"""What the benchmark's files import, by whole top-level module name: no
file imports JAX or the JAX package, and the plain reference imports
nothing of the program under test either."""
import ast
import os

import pytest

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "sha2cq_tpu"}
PROGRAM = "sha2cq_tpu_torch"


def sources(sub=""):
    out = []
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def top_names(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sources(), ids=lambda p: os.path.relpath(p, HERE))
def test_no_jax(path):
    assert not top_names(path) & JAX


@pytest.mark.parametrize("path", sources("reference"),
                         ids=lambda p: os.path.relpath(p, HERE))
def test_reference_stands_alone(path):
    names = top_names(path)
    assert PROGRAM not in names and not names & JAX
    assert names <= {"__future__", "hashlib", "operator", "typing", "numpy",
                     "cardbench"}


def test_loaded_modules_are_compared_whole(monkeypatch):
    """harness.forbidden_modules names a loaded `sha2cq_tpu` or `jax`, and
    not `sha2cq_tpu_torch`, whose name begins with the JAX package's."""
    import sys
    import types

    from cardbench import harness
    monkeypatch.setitem(sys.modules, "sha2cq_tpu_torch_probe", types.ModuleType("p"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "sha2cq_tpu.fields", types.ModuleType("q"))
    assert harness.forbidden_modules() == ["sha2cq_tpu"]
