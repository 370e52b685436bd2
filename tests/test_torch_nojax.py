"""The port must run where jax is not installed and the JAX package is not
beside it: its main path imports with jax blocked, every module it loads is
its own file, no port file imports jax, and its entry points default to the
card."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

import sha2cq_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MAIN_PATH = [
    "sha2cq_tpu_torch.plonk",
    "sha2cq_tpu_torch.plonk.prover",
    "sha2cq_tpu_torch.plonk.device_eval",
    "sha2cq_tpu_torch.plonk.h_vm",
    "sha2cq_tpu_torch.plonk.keygen",
    "sha2cq_tpu_torch.plonk.verifier",
    "sha2cq_tpu_torch.plonk.static_lookup",
    "sha2cq_tpu_torch.ops.mxu_ntt",
    "sha2cq_tpu_torch.ops.cuda_field",
    "sha2cq_tpu_torch.ops.kernels",
    "sha2cq_tpu_torch.ops.msm",
    "sha2cq_tpu_torch.curves.device",
    "sha2cq_tpu_torch.ops.ntt",
    "sha2cq_tpu_torch.fields.device",
    "sha2cq_tpu_torch.poly.domain",
    "sha2cq_tpu_torch.poly.kzg.params",
    "sha2cq_tpu_torch.poly.kzg.strategy",
    "sha2cq_tpu_torch.utils.transcript",
    "sha2cq_tpu_torch.models.sha.circuit32",
    "sha2cq_tpu_torch.models.sha.setup32",
    "sha2cq_tpu_torch.models.simple",
    "sha2cq_tpu_torch.native_loader",
    "sha2cq_tpu_torch.compat",
]

PROBE = """
import importlib, json, sys
sys.modules["jax"] = None
for name in %r:
    importlib.import_module(name)
loaded = [m for m, mod in sys.modules.items() if mod is not None]
print(json.dumps([sorted(m for m in loaded if m.split(".")[0] == root)
                  for root in ("sha2cq_tpu", "jax")]))
""" % (MAIN_PATH,)


def test_main_path_imports_without_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[[], []]"


ROUTES_PROBE = """
import json, sys
sys.modules["jax"] = None
from sha2cq_tpu_torch import compat as C
from sha2cq_tpu_torch.plonk import device_eval as DE
case = C.build_simple(4, 31)
outs = [C.h_forward(case.pk, "cpu", 3, use_mxu=m, cosets=c)
        for m, c in ((False, None), (True, False), (True, True))]
routes = sorted(r for _, r in case.pk.__dict__["_torch_h_fns"])
same = all(x.long().equal(y.long()) for o in outs[1:]
           for x, y in zip(o, outs[0]))
loaded = [m for m, mod in sys.modules.items() if mod is not None]
print(json.dumps([routes, same] + [
    sorted(m for m in loaded if m.split(".")[0] == root)
    for root in ("sha2cq_tpu", "jax")]))
"""


def test_three_h_routes_run_without_jax():
    """The butterfly, monolithic and coset-streamed h modules build and run
    with jax blocked (ops.ntt, poly.domain, ops.mxu_ntt, plonk.h_vm and
    plonk.device_eval included), and agree."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", ROUTES_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == \
        '[["butterfly", "coset", "monolithic"], true, [], []]'


def test_no_port_file_imports_jax():
    pkg = os.path.dirname(sha2cq_tpu_torch.__file__)
    pat = re.compile(r"^\s*(import jax|from jax)\b", re.M)
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if f.endswith(".py"):
                path = os.path.join(dirpath, f)
                with open(path) as fh:
                    if pat.search(fh.read()):
                        offenders.append(path)
    assert offenders == []


def _names_jax_package(source: str) -> list:
    """Lines of `source` that import the JAX package, hold its module name
    in a string other than a docstring (a name for importlib, say), or
    import a module by a computed name (nothing here can tell what that
    loads).  A path such as "sha2cq_tpu/ops/ntt.py:65" is a reference to
    the reference, not a module name, and sys.modules["sha2cq_tpu"] (the
    smoke's block of the package) loads nothing."""
    tree = ast.parse(source)
    docs = {id(node.value) for node in ast.walk(tree)
            if isinstance(node, ast.Expr) and
            isinstance(node.value, ast.Constant)}
    docs |= {id(node.slice) for node in ast.walk(tree)
             if isinstance(node, ast.Subscript) and
             ast.unparse(node.value) == "sys.modules"}
    module = re.compile(r"sha2cq_tpu(\.\w*)*")
    hits = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            names = [node.value] if id(node) not in docs else []
        elif isinstance(node, ast.Call):
            called = getattr(node.func, "attr", None) or \
                getattr(node.func, "id", None)
            computed = called in ("import_module", "__import__") and not (
                node.args and isinstance(node.args[0], ast.Constant))
            names = ["sha2cq_tpu"] if computed else []
        else:
            continue
        if any(module.fullmatch(n) for n in names):
            hits.append(node.lineno)
    return hits


@pytest.mark.parametrize("source,hits", [
    ('"""A copy of sha2cq_tpu/x.py."""\nimport sha2cq_tpu_torch.plonk\n', []),
    ("from sha2cq_tpu.plonk import keys\n", [1]),
    ('import importlib\nPKG = "sha2cq_tpu"\n', [2]),
    ("import importlib\nimportlib.import_module(f'{p}.plonk')\n", [2]),
    ('x = 1\nm = __import__("sha2cq_tpu.fields")\n', [2]),
    ('import sys\nsys.modules["sha2cq_tpu"] = None\nR = "sha2cq_tpu/a.py:7"\n',
     []),
])
def test_jax_package_scan_finds_references(source, hits):
    assert _names_jax_package(source) == hits


def test_no_port_file_names_the_jax_package():
    """No file of the port, and not chip_smoke.py, imports the JAX package,
    names it outside a docstring (a package name handed to importlib, say)
    or imports a module by a computed name."""
    pkg = os.path.dirname(sha2cq_tpu_torch.__file__)
    paths = [os.path.join(ROOT, "chip_smoke.py")] + [
        os.path.join(d, f) for d, _, files in os.walk(pkg)
        for f in files if f.endswith(".py")]
    offenders = {}
    for path in paths:
        with open(path) as fh:
            hits = _names_jax_package(fh.read())
        if hits:
            offenders[os.path.relpath(path, ROOT)] = hits
    assert len(paths) >= 50 and offenders == {}


OWN_FILES_PROBE = """
import importlib, json, os, pkgutil, sys
import torch
sys.modules["jax"] = None
def no_card_probe(*a, **k):
    raise RuntimeError("a port module probed for a card at import")
for name in ("is_available", "device_count", "current_device", "init"):
    setattr(torch.cuda, name, no_card_probe)
import sha2cq_tpu_torch
pkg = os.path.dirname(os.path.abspath(sha2cq_tpu_torch.__file__))
for info in pkgutil.walk_packages(sha2cq_tpu_torch.__path__, "sha2cq_tpu_torch."):
    importlib.import_module(info.name)
mods = {m: mod for m, mod in sys.modules.items()
        if mod is not None and m.split(".")[0] == "sha2cq_tpu_torch"}
outside = sorted(m for m, mod in mods.items()
                 if not os.path.abspath(mod.__file__).startswith(pkg + os.sep))
paths = sorted(m for m, mod in mods.items()
               for p in getattr(mod, "__path__", [])
               if os.path.abspath(p) != pkg and
               not os.path.abspath(p).startswith(pkg + os.sep))
print(json.dumps([len(mods), outside, paths] + [
    sorted(m for m in sys.modules if sys.modules[m] is not None
           and m.split(".")[0] == root) for root in ("sha2cq_tpu", "jax")]))
"""


def test_every_port_module_is_a_file_of_the_port():
    """Every module of the port imports with jax blocked and without
    probing for a card, and each loaded sha2cq_tpu_torch.* module is a file
    under sha2cq_tpu_torch/: no module comes from sha2cq_tpu/ and no
    package's __path__ reaches outside the port."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    res = subprocess.run([sys.executable, "-c", OWN_FILES_PROBE], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    n_mods, outside, paths, ref, jax = json.loads(
        res.stdout.strip().splitlines()[-1])
    assert n_mods >= 50
    assert (outside, paths, ref, jax) == ([], [], [], [])


STANDALONE_PROBE = """
import json, os, sys
sys.modules["jax"] = None
sys.modules["sha2cq_tpu"] = None
from sha2cq_tpu_torch import compat as C
case = C.build_simple(4, %d)
proof = C.prove(case, %d, device="cpu")
here = os.getcwd() + os.sep
files = [os.path.abspath(m.__file__) for n, m in sys.modules.items()
         if m is not None and n.split(".")[0] == "sha2cq_tpu_torch"]
print(json.dumps([proof.hex(), C.verify(case, proof),
                  sorted(f for f in files if not f.startswith(here))]))
"""


def test_port_proves_without_the_jax_package_beside_it(tmp_path):
    """A directory holding only sha2cq_tpu_torch/ and native/fieldops.c
    (no sha2cq_tpu/): the port imports with jax and sha2cq_tpu blocked and
    proves models/simple at k=4 on device="cpu", byte for byte the proof
    made in the repo, and it verifies."""
    import shutil

    from sha2cq_tpu_torch import compat as C
    shutil.copytree(os.path.join(ROOT, "sha2cq_tpu_torch"),
                    tmp_path / "sha2cq_tpu_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "_build"))
    (tmp_path / "native").mkdir()
    shutil.copy(os.path.join(ROOT, "native", "fieldops.c"),
                tmp_path / "native" / "fieldops.c")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    res = subprocess.run([sys.executable, "-c", STANDALONE_PROBE % (41, 42)],
                         cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    proof_hex, verified, outside = json.loads(
        res.stdout.strip().splitlines()[-1])
    want = C.prove(C.build_simple(4, 41), 42, device="cpu")
    assert bytes.fromhex(proof_hex) == want
    assert verified and outside == []


@pytest.mark.parametrize("entry,param,default", [
    ("plonk.prover.create_proof", "device", "cuda"),
    ("plonk.prover.create_proof", "h_device", True),
    ("plonk.prover.prewarm_prover", "device", "cuda"),
    ("plonk.device_eval.get_h_fn", "device", "cuda"),
    ("plonk.device_eval.build_h_fn", "device", "cuda"),
    ("ops.msm.msm_device", "device", "cuda"),
])
def test_entry_points_default_to_the_card(entry, param, default):
    """The entry points run on the card unless the caller asks for the CPU
    (device="cpu", or h_device=False for the host path)."""
    import importlib
    import inspect
    mod, name = entry.rsplit(".", 1)
    fn = getattr(importlib.import_module(f"sha2cq_tpu_torch.{mod}"), name)
    assert inspect.signature(fn).parameters[param].default == default
