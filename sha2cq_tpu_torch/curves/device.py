"""Device G1 point arithmetic of the port: branch-free Jacobian ops over Fq
limbs (counterpart of sha2cq_tpu/curves/device.py).

A batch of points is three (16, *batch) int32 Montgomery-limb tensors
(X, Y, Z); the identity is Z == 0, and add/double are complete by mask
selection.  The formulas, the grouping of the products into batched
rounds and the edge-case masking are the reference's, so every output limb
equals the JAX package's.  Each round is one `D.mont_mul` over lanes
concatenated along the last axis: the plain version on a CPU tensor, kernel
K1 on a CUDA tensor.

These are the plain versions of the point code the MSM kernels K5 and K6
compute (csrc/msm.cu, ops/msm.py).
"""
from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch

from ..fields import device as D
from ..fields.device import FQ, FR, LIMB, MASK, NLIMB
from ..utils.profiling import profiler

# A point batch: (X, Y, Z) Jacobian, each (16, *batch); Z=0 encodes identity.
PointArray = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def identity_like(shape, device=None) -> PointArray:
    one = D.ones(shape, FQ, device)
    return (one, one, D.zeros(shape, FQ, device))


def is_identity(p: PointArray) -> torch.Tensor:
    return D.is_zero(p[2])


def _mulround(pairs):
    """One batched Montgomery multiply for a list of independent products.
    pairs: [(a, b), ...] with equal shapes; returns the list of products."""
    a = torch.cat([p[0] for p in pairs], dim=-1)
    b = torch.cat([p[1] for p in pairs], dim=-1)
    r = D.mont_mul(a, b, FQ)
    w = pairs[0][0].shape[-1]
    return [r[..., i * w:(i + 1) * w] for i in range(len(pairs))]


def _add(a, b):
    return D.add(a, b, FQ)


def _sub(a, b):
    return D.sub(a, b, FQ)


def _dbl2(a):
    return D.add(a, a, FQ)


def point_double(p: PointArray) -> PointArray:
    """Jacobian doubling (dbl-2009-l, a = 0).  Identity-safe: Z=0 -> Z3=0."""
    X, Y, Z = p
    A, B, ZZ = _mulround([(X, X), (Y, Y), (Y, Z)])
    XB = _add(X, B)
    C, t = _mulround([(B, B), (XB, XB)])
    Dd = _dbl2(_sub(_sub(t, A), C))
    E = _add(_dbl2(A), A)
    F, = _mulround([(E, E)])
    X3 = _sub(F, _dbl2(Dd))
    Y3a, = _mulround([(E, _sub(Dd, X3))])
    Y3 = _sub(Y3a, _dbl2(_dbl2(_dbl2(C))))
    return (X3, Y3, _dbl2(ZZ))


def point_add(p: PointArray, q: PointArray) -> PointArray:
    """Complete unified Jacobian addition (add-2007-bl + masked edge cases).

    Handles p/q identity, p == q (double leg, fused into the same multiply
    rounds), p == -q (identity result).  6 batched mont_mul rounds."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q

    Z1Z1, Z2Z2, A, B = _mulround([(Z1, Z1), (Z2, Z2), (X1, X1), (Y1, Y1)])
    E = _add(_dbl2(A), A)  # 3A (double leg)

    XB = _add(X1, B)
    U1, U2, ZA, ZB, C, t, F, YZ = _mulround([
        (X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1),
        (B, B), (XB, XB), (E, E), (Y1, Z1),
    ])
    Dd = _dbl2(_sub(_sub(t, A), C))
    X3d = _sub(F, _dbl2(Dd))
    Z3d = _dbl2(YZ)

    S1, S2, Y3d_ = _mulround([(Y1, ZA), (Y2, ZB), (E, _sub(Dd, X3d))])
    Y3d = _sub(Y3d_, _dbl2(_dbl2(_dbl2(C))))
    H = _sub(U2, U1)
    r = _sub(S2, S1)

    HH, rr = _mulround([(H, H), (r, r)])
    HHH, V, ZZ12 = _mulround([(H, HH), (U1, HH), (Z1, Z2)])
    X3 = _sub(_sub(rr, HHH), _dbl2(V))
    T1, T2, Z3 = _mulround([(r, _sub(V, X3)), (S1, HHH), (ZZ12, H)])
    Y3 = _sub(T1, T2)

    h_zero = D.is_zero(H)
    r_zero = D.is_zero(r)
    p_inf = D.is_zero(Z1)
    q_inf = D.is_zero(Z2)

    iX, iY, iZ = identity_like(X3.shape[1:], X3.device)
    same = h_zero & ~p_inf & ~q_inf
    X3 = D.select(same & r_zero, X3d, D.select(same & ~r_zero, iX, X3))
    Y3 = D.select(same & r_zero, Y3d, D.select(same & ~r_zero, iY, Y3))
    Z3 = D.select(same & r_zero, Z3d, D.select(same & ~r_zero, iZ, Z3))
    X3 = D.select(p_inf, X2, D.select(q_inf & ~p_inf, X1, X3))
    Y3 = D.select(p_inf, Y2, D.select(q_inf & ~p_inf, Y1, Y3))
    Z3 = D.select(p_inf, Z2, D.select(q_inf & ~p_inf, Z1, Z3))
    return (X3, Y3, Z3)


def point_neg(p: PointArray) -> PointArray:
    X, Y, Z = p
    return (X, D.neg(Y, FQ), Z)


def select_point(mask, p: PointArray, q: PointArray) -> PointArray:
    return tuple(D.select(mask, a, b) for a, b in zip(p, q))


# ----------------------- host conversion helpers ----------------------------

def pack_affine(points=None, device=None, packed=None, n=None) -> PointArray:
    """Host affine points (None = identity) -> Jacobian batch on `device`.

    packed: a native basis (native_loader.pack_points_affine: 12 u64 a point,
    canonical x, y, z in four little-endian words each, z = 1) whose first
    n points (all of them by default) are taken instead of `points`.  Its
    words are cut into 16-bit limbs with tensor ops and turned into
    Montgomery form on `device` (one product by R^2 mod q: K1 on a card).
    The device MSM calls this once per packed basis and device and keeps
    K5's words of the result (ops/msm._upload_basis), so a commitment
    basis is uploaded and cut once, not on every MSM."""
    if packed is None:
        xs = [0 if pt is None else pt[0] for pt in points]
        ys = [1 if pt is None else pt[1] for pt in points]
        zs = [0 if pt is None else 1 for pt in points]
        return tuple(D.pack(v, FQ, device=device) for v in (xs, ys, zs))
    words = np.ctypeslib.as_array(packed).view(np.int64).reshape(-1, 12)
    if n is None:
        n = words.shape[0]
    words = words[:n]
    if not ((words[:, 8] == 1).all() and (words[:, 9:] == 0).all()):
        raise ValueError("a packed basis holds affine points (z = 1)")
    xy = D.to_device(torch.from_numpy(np.ascontiguousarray(words[:, :8])),
                     device)
    limbs = xy.view(torch.int16).t().to(LIMB) & MASK        # (32, n): x, y
    xy = D.to_mont(torch.cat([limbs[:NLIMB], limbs[NLIMB:]], dim=1), FQ)
    return (xy[:, :n], xy[:, n:], D.ones((n,), FQ, device))


def unpack_jacobian(p: PointArray):
    """Device Jacobian batch -> list of host affine points (None = identity)."""
    from ..fields.host import FQ_MOD, inv_mod
    X = D.unpack(p[0], FQ)
    Y = D.unpack(p[1], FQ)
    Z = D.unpack(p[2], FQ)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zi = inv_mod(z, FQ_MOD)
        zi2 = zi * zi % FQ_MOD
        out.append((x * zi2 % FQ_MOD, y * zi2 * zi % FQ_MOD))
    return out


# ----------- scalar products and the group NTT (kernels K7, K8) -------------
#
# The CQ tables' cached quotients (plonk/static_tables.fk_cached_quotients)
# are two group NTTs and two rows of scalar products over G1.  A CUDA
# tensor launches K7 / K8 (csrc/fk.cu); a CPU tensor runs the host's own
# versions on host integers (curves/host.jac_mul and the host FK's group
# NTT): a limb-tensor version would run some 1,700 batched Montgomery
# rounds a scalar product, seconds each even at test sizes.


def limb_ints(a: torch.Tensor) -> list:
    """(16, *batch) limbs -> the integers they spell, flattened batch, not
    reduced: cut to 16 bits and laid out element by element where the
    tensor lives, then one copy (a card's tensor: one host wait, counted)."""
    t = a.reshape(NLIMB, -1).to(torch.int16).t().contiguous()
    if D.on_card(t):
        profiler.count("host_syncs")
    raw = memoryview(t.cpu().numpy().tobytes())
    fb = int.from_bytes
    return [fb(raw[i:i + 32], "little") for i in range(0, len(raw), 32)]


def raw_limbs(values) -> torch.Tensor:
    """Integers below 2^256 -> (16, n) int32 limbs, not reduced (a scalar
    row for batch_scalar_mul)."""
    raw = b"".join(v.to_bytes(32, "little") for v in values)
    a = np.frombuffer(raw, dtype="<u2").reshape(len(values), NLIMB).T
    return torch.from_numpy(a.astype(np.int32))


def _host_points(p: PointArray) -> list:
    """A point batch -> host Jacobian tuples (ints, out of Montgomery form)."""
    from .host import JAC_IDENTITY
    rinv = pow(FQ.r, FQ.p - 2, FQ.p)
    out = []
    for x, y, z in zip(*(limb_ints(c) for c in p)):
        out.append(JAC_IDENTITY if z == 0 else
                   (x * rinv % FQ.p, y * rinv % FQ.p, z * rinv % FQ.p))
    return out


def _device_points(points: list, shape, device) -> PointArray:
    return tuple(D.pack([pt[i] for pt in points], FQ, device=device)
                 .reshape(NLIMB, *shape) for i in range(3))


def _one_device(op: str, *tensors) -> torch.device:
    """The device every tensor lives on: a CPU or a CUDA one, else raises."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError(f"{op}: operands on different devices "
                         f"({sorted({str(t.device) for t in tensors})})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{op}: no route for tensors on {dev}")
    return dev


def batch_scalar_mul(points: PointArray, scalars: torch.Tensor) -> PointArray:
    """out[e] = s[e mod n_sc] * P[e mod n_pts] over the larger of the two
    batches (the smaller one's count divides it, and its shape is the
    other's trailing axes): scalars (16, ...) canonical limbs below 2^256,
    points (16, ...) a coordinate, on the scalars' device.  CUDA tensors
    launch K7, CPU tensors run curves/host.jac_mul point by point."""
    from ..ops import cuda_field as CF
    from ..ops import kernels as K
    n_pts, n_sc = points[0][0].numel(), scalars[0].numel()
    shape = max(points[0].shape[1:], scalars.shape[1:],
                key=lambda s: (s.numel(), len(s)))
    n = max(n_pts, n_sc)
    if n_pts == 0 or n_sc == 0 or n % n_pts or n % n_sc:
        raise ValueError(f"batch_scalar_mul: {n_pts} points against {n_sc} "
                         "scalars")
    dev = _one_device("batch_scalar_mul", *points, scalars)
    if dev.type == "cpu":
        from .host import jac_mul
        pts, ss = _host_points(points), limb_ints(scalars)
        out = [jac_mul(pts[e % n_pts], ss[e % n_sc]) for e in range(n)]
        return _device_points(out, shape, dev)
    px, py, pz = (c.contiguous() for c in points)
    sc = CF.as_limbs32(scalars).contiguous()
    out = tuple(torch.empty((NLIMB, *shape), dtype=LIMB, device=sc.device)
                for _ in range(3))
    p8, n0 = K.field_words(FQ)
    CF.count_launch("g1_scalar_mul")
    K.check(K.get_lib().k7_g1_scalar_mul(
        px.data_ptr(), py.data_ptr(), pz.data_ptr(), n_pts, sc.data_ptr(),
        n_sc, out[0].data_ptr(), out[1].data_ptr(), out[2].data_ptr(), n, p8,
        n0, K.one_words(FQ), K.stream_ptr(sc)), "k7_g1_scalar_mul")
    return out


@functools.lru_cache(maxsize=16)
def _group_twiddles(omega: int, k: int, device: str) -> torch.Tensor:
    from ..fields.host import FR_MOD
    tw = [1] * max((1 << k) // 2, 1)
    for i in range(1, len(tw)):
        tw[i] = tw[i - 1] * omega % FR_MOD
    return D.pack(tw, FR, mont=False, device=device)


def group_twiddles(omega: int, k: int, device) -> torch.Tensor:
    """(16, 2^(k-1)) canonical limbs of omega^i, K8's twiddles (built once
    per table and device; callers must not write to it)."""
    return _group_twiddles(omega, k, D.device_key(device))


@functools.lru_cache(maxsize=32)
def _bitrev(k: int) -> np.ndarray:
    idx = np.arange(1 << k, dtype=np.int64)
    rev = np.zeros_like(idx)
    for b in range(k):
        rev |= ((idx >> b) & 1) << (k - 1 - b)
    return rev


def group_ntt(points: PointArray, omega: int) -> PointArray:
    """out_k = sum_j omega^{jk} P_j along the last axis (m = 2^k points) of
    a point batch (16, ..., m), omega an m-th root of unity of Fr.  A CUDA
    tensor: the bit-reversal gathered by torch, then K8 in place, one
    launch a stage; CPU tensors: the host FK's group NTT column by column
    (plonk/static_tables._group_ntt_any).  Counts group_ntt_points (the
    points transformed)."""
    from ..ops import cuda_field as CF
    from ..ops import kernels as K
    m = points[0].shape[-1]
    k = m.bit_length() - 1
    if m < 1 or m & (m - 1):
        raise ValueError(f"group_ntt: {m} points is not a power of two")
    dev = _one_device("group_ntt", *points)
    profiler.count("group_ntt_points", points[0][0].numel())
    if dev.type == "cpu":
        from ..plonk.static_tables import _group_ntt_any
        flat = _host_points(points)
        out = [q for c0 in range(0, len(flat), m)
               for q in _group_ntt_any(flat[c0:c0 + m], omega, k)]
        return _device_points(out, points[0].shape[1:], dev)
    rev = torch.from_numpy(_bitrev(k)).to(dev)
    x, y, z = (c.index_select(-1, rev).contiguous() for c in points)
    tw = group_twiddles(omega, k, dev)
    p8, n0 = K.field_words(FQ)
    CF.count_launch("g1_ntt")
    K.check(K.get_lib().k8_g1_ntt(
        x.data_ptr(), y.data_ptr(), z.data_ptr(), tw.data_ptr(),
        x[0].numel() >> k, k, p8, n0, K.one_words(FQ), K.stream_ptr(x)),
        "k8_g1_ntt")
    return (x, y, z)


def to_affine(p: PointArray) -> torch.Tensor:
    """A point batch -> (16, 2, n) canonical limbs of affine x and y,
    flattened batch, made on the device (a Fermat inversion a point: K1 on
    a card); an identity's x is 2^256 - 1, which no coordinate reaches."""
    X, Y, Z = (c.reshape(NLIMB, -1) for c in p)
    zi = D.inv(Z, FQ)
    zi2 = D.mont_sq(zi, FQ)
    x = D.from_mont(D.mont_mul(X, zi2, FQ), FQ)
    y = D.from_mont(D.mont_mul(D.mont_mul(Y, zi2, FQ), zi, FQ), FQ)
    x = torch.where(D.is_zero(Z), MASK, x)
    return torch.stack([x, y], dim=1)


def to_affine_host(p: PointArray) -> list:
    """A point batch -> host affine points, flattened batch (None = the
    identity): to_affine, then one copy of x and y."""
    vals = limb_ints(to_affine(p))
    n, none = len(vals) // 2, (1 << 256) - 1
    return [None if a == none else (a, b) for a, b in zip(vals[:n], vals[n:])]
