"""The port must run where jax is not installed: its main path imports with
jax blocked, loads nothing of the JAX package, and no port file imports
jax."""
import os
import re
import subprocess
import sys

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
case = C.build_simple(C.PORT, 4, 31)
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


def test_overlay_loads_reference_host_modules_under_the_port_name():
    """A host module the port does not define comes from sha2cq_tpu/'s
    file, and its relative imports resolve to the port's overrides."""
    from sha2cq_tpu_torch.plonk import keygen
    from sha2cq_tpu_torch.poly import domain
    assert keygen.__file__.endswith(os.path.join("sha2cq_tpu", "plonk", "keygen.py"))
    assert keygen.EvaluationDomain is domain.EvaluationDomain
    assert domain.__file__.endswith(
        os.path.join("sha2cq_tpu_torch", "poly", "domain.py"))
