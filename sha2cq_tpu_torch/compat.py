"""Carrying state between the JAX package and the port.

Limbs: the reference keeps (16, ...) uint32 arrays of 16-bit limbs; the port
keeps the same layout in int32 tensors.  `from_jax_limbs` / `to_jax_limbs`
convert numpy arrays taken from the JAX side.

Keys and circuits: a class has a different identity in each package
(`sha2cq_tpu.plonk.circuit_ir.Column` is not
`sha2cq_tpu_torch.plonk.circuit_ir.Column`), so each side builds its own
circuit, params and keys from the same seeds with `build_sha256` /
`build_simple`, passing its package name; the two sides are then compared
through ints, limbs and proof bytes only.  The package is imported by name,
so this module imports nothing of the JAX package unless asked to.
"""
from __future__ import annotations

import importlib
import random
from types import SimpleNamespace

import numpy as np
import torch

PORT = "sha2cq_tpu_torch"
REFERENCE = "sha2cq_tpu"


def from_jax_limbs(a: np.ndarray) -> torch.Tensor:
    """(16, ...) uint32 limb array from the JAX side -> int32 limb tensor."""
    a = np.asarray(a)
    if a.shape[:1] != (16,) or (a > 0xFFFF).any():
        raise ValueError("expected (16, ...) 16-bit limbs")
    return torch.from_numpy(a.astype(np.int32))


def to_jax_limbs(t: torch.Tensor) -> np.ndarray:
    """Limb tensor (int32, or int16 storage) -> (16, ...) uint32 array."""
    from .fields.device import limbs_np
    return limbs_np(t)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def build_sha256(pkg: str, k: int, nblocks: int, seed: int,
                 scheme: str = "SCHEME8", cache: bool = False):
    """SHA-256 circuit32 under `scheme` with `nblocks` chained random blocks,
    its table setup, KZG params and keys, all from `seed`.  The public
    instance is the digest from the circuit's own model.  cache=False keeps
    pickled setups of the other package out of this process."""
    P = _mod(pkg, "fields.host").FR_MOD
    setup32 = _mod(pkg, "models.sha.setup32")
    tables32 = _mod(pkg, "models.sha.tables32")
    circuit32 = _mod(pkg, "models.sha.circuit32")
    plonk = _mod(pkg, "plonk")
    params_mod = _mod(pkg, "poly.kzg.params")
    sch = getattr(tables32, scheme)
    rng = random.Random(seed)
    s = rng.randrange(P)
    tables, configs, b0, _srs = setup32.build_sha256_setup(
        sch, 1 << k, s, cache=cache)
    params = params_mod.ParamsKZG.setup_from_toxic_waste(k, s)
    circ_cls = type(f"Sha256Circuit_{scheme}", (circuit32.Sha256Circuit,),
                    {"SCHEME": sch})
    wb = sch.word_bits
    blocks = [[rng.randrange(1 << wb) for _ in range(16)]
              for _ in range(nblocks)]
    circuit = circ_cls(blocks, tables)
    digest = list(circuit.expected_digest())
    vk = plonk.keygen_vk(params, circuit)
    pk = plonk.keygen_pk(params, configs, b0, vk, circuit)
    return SimpleNamespace(params=params, vk=vk, pk=pk, circuits=[circuit],
                           instances=[[digest]], k=k)


def build_simple(pkg: str, k: int, seed: int, n_circuits: int = 1):
    """models/simple.py's SimpleCircuit, `n_circuits` instances in one
    proof, params and keys from `seed`."""
    P = _mod(pkg, "fields.host").FR_MOD
    simple = _mod(pkg, "models.simple")
    plonk = _mod(pkg, "plonk")
    params_mod = _mod(pkg, "poly.kzg.params")
    rng = random.Random(seed)
    s = rng.randrange(P)
    params = params_mod.ParamsKZG.setup_from_toxic_waste(k, s)
    circuits, instances = [], []
    for _ in range(n_circuits):
        a0, b0 = rng.randrange(P), rng.randrange(P)
        circuits.append(simple.SimpleCircuit(a0, b0))
        instances.append([[b0, a0]])
    vk = plonk.keygen_vk(params, circuits[0])
    pk = plonk.keygen_pk(params, {}, [], vk, circuits[0])
    return SimpleNamespace(params=params, vk=vk, pk=pk, circuits=circuits,
                           instances=instances, k=k)


def prove(pkg: str, case, seed: int, **kw) -> bytes:
    """create_proof of a built case under random.Random(seed)."""
    plonk = _mod(pkg, "plonk")
    return plonk.create_proof(case.params, case.pk, case.circuits,
                              case.instances, rng=random.Random(seed), **kw)


def verify(pkg: str, case, proof: bytes, seed: int = 0) -> bool:
    """verify_proof(...).check() of a proof against a built case."""
    plonk = _mod(pkg, "plonk")
    strategy = _mod(pkg, "poly.kzg.strategy")
    transcript = _mod(pkg, "utils.transcript")
    batcher = plonk.verify_proof(
        case.params, case.vk,
        strategy.AccumulatorStrategy(case.params, rng=random.Random(seed)),
        case.instances, transcript.Blake2bRead(proof))
    return bool(batcher.check())
