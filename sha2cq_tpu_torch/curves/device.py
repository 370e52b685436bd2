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

from typing import Tuple

import numpy as np
import torch

from ..fields import device as D
from ..fields.device import FQ, LIMB, MASK, NLIMB

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
