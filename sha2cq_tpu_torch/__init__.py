"""sha2cq_tpu_torch: the PyTorch + CUDA (NVIDIA Hopper) port of sha2cq_tpu.

The JAX package `sha2cq_tpu` beside this one is the reference.  Most of the
proving stack is framework-neutral host code (circuit IR, keygen, transcript,
KZG/GWC/SHPLONK, CQ, verifier, the native C layer); this package does not
copy it.  Instead every (sub)package of the port extends its `__path__` with
the matching directory of `sha2cq_tpu/`:

  * a module the port defines itself (fields/device.py, ops/mxu_ntt.py,
    plonk/prover.py, ...) wins, because the port's directory comes first;
  * every other module (plonk/keygen.py, poly/kzg/gwc.py, models/sha/*, ...)
    is loaded from the JAX package's file under the PORT's name, so its
    relative imports (`from ..poly.domain import EvaluationDomain`) resolve
    to the port's overrides.

The JAX package's own `__init__` never runs and jax is never imported: the
port overrides exactly the modules that touch jax or the device.  A class
therefore has a different identity on each side
(`sha2cq_tpu.plonk.circuit_ir.Column` is not
`sha2cq_tpu_torch.plonk.circuit_ir.Column`); compare ints, limbs and proof
bytes across the two packages, never objects.

Device code: limb arrays keep the reference layout, (16, *batch) 16-bit
limbs of Montgomery-form (R = 2^256) BN254 elements, as int32 tensors.  A
CPU tensor goes through each kernel's plain PyTorch version; a CUDA tensor
goes through the hand-written sm_90a kernel in csrc/ (see ops/kernels.py).
"""
import os

REFERENCE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "sha2cq_tpu")


def _overlay(pkg_path, sub: str = "") -> None:
    """Append the reference package's directory for subpackage `sub` to a
    port package's `__path__` (after the port's own directory)."""
    ref = os.path.join(REFERENCE_ROOT, *sub.split(".")) if sub else REFERENCE_ROOT
    if not os.path.isdir(ref):
        raise ImportError(f"reference package directory missing: {ref}")
    if ref not in pkg_path:
        pkg_path.append(ref)


_overlay(__path__)
