"""Carrying state between the JAX package and the port.

Limbs: the reference keeps (16, ...) uint32 arrays of 16-bit limbs (uint16
for column stacks); the port keeps the same layout in int32 tensors (int16
storage for column stacks).  `from_jax_limbs` / `to_jax_limbs` convert numpy
arrays taken from the JAX side, including stacks whose limb axis is not the
first, such as the coset route's (rs, 16, n) twist.

Routes: `h_forward` runs one key's device h module under a chosen route on
seeded random canonical inputs, so tests and the card smoke compare the
routes on the same inputs.

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


def from_jax_limbs(a: np.ndarray, limb_axis: int = 0,
                   dtype=torch.int32) -> torch.Tensor:
    """Limb array from the JAX side (uint32 or uint16, 16 limbs on
    `limb_axis`) -> limb tensor of `dtype` (int32, or int16 storage)."""
    a = np.asarray(a)
    if a.ndim <= limb_axis or a.shape[limb_axis] != 16 or (a > 0xFFFF).any():
        raise ValueError(f"expected 16-bit limbs, 16 on axis {limb_axis}")
    if dtype == torch.int16:
        return torch.from_numpy(np.ascontiguousarray(
            a.astype(np.uint16)).view(np.int16))
    if dtype != torch.int32:
        raise TypeError(f"limb tensors are int32 or int16, not {dtype}")
    return torch.from_numpy(a.astype(np.int32))


def to_jax_limbs(t: torch.Tensor) -> np.ndarray:
    """Limb tensor (int32, or int16 storage) -> (16, ...) uint32 array."""
    from .fields.device import limbs_np
    return limbs_np(t)


def _mod(pkg: str, name: str):
    return importlib.import_module(f"{pkg}.{name}")


def random_limbs(rng: np.random.Generator, shape, p: int) -> np.ndarray:
    """Canonical random field elements as (16, *shape) uint16 limbs: random
    16-bit limbs with the top one kept below p's, so every value < p."""
    a = rng.integers(0, 1 << 16, size=(16, *shape), dtype=np.uint16)
    a[15] %= np.uint16(p >> 240)
    return a


def h_input_widths(pk) -> dict:
    """Column counts of the device h inputs of one circuit under pk."""
    cs = pk.vk.cs
    columns = cs.permutation.columns
    chunk_len = max(pk.vk.cs_degree - 2, 1)
    nq = len(cs.static_lookups)
    return {"advice": cs.num_advice_columns,
            "instance": cs.num_instance_columns,
            "z": -(-len(columns) // chunk_len) if columns else 0,
            "lookups": 3 * len(cs.lookups), "static_b": nq, "static_f": nq}


def h_inputs(pk, device, seed: int):
    """Canonical inputs of pk's device h module made from numpy's
    default_rng(seed): the six (16, C, n) int16 Lagrange stacks on `device`
    (HFn.forward's order) and the runtime scalars [y, beta, gamma, theta,
    *challenges] as ints.  They do not depend on the route or the device."""
    p = _mod(PORT, "fields.host").FR_MOD
    rng = np.random.default_rng(seed)
    n = pk.vk.domain.n
    stacks = [from_jax_limbs(random_limbs(rng, (c, n), p), dtype=torch.int16)
              .to(device) for c in h_input_widths(pk).values()]
    runtime = [int(v) % p for v in rng.integers(0, 1 << 62, size=4 +
                                                pk.vk.cs.num_challenges)]
    return stacks, runtime


def h_forward(pk, device, seed: int, use_mxu=None, cosets=None):
    """One forward of pk's device h module for the route use_mxu / cosets
    select (as create_proof's h_mxu / h_cosets do) on h_inputs(pk, device,
    seed).  Returns (h coefficients, advice coefficients) on `device`."""
    from .plonk.device_eval import get_h_fn
    stacks, runtime = h_inputs(pk, device, seed)
    fn = get_h_fn(pk, device, use_mxu, cosets)
    return fn(*stacks, fn.scalar_table(*runtime[:4], runtime[4:]))


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
