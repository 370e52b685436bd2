"""Device finite-field arithmetic for BN254 in PyTorch (counterpart of
sha2cq_tpu/fields/device.py).

Layout, as in the reference: a field element is sixteen 16-bit limbs, arrays
are limbs-leading (16, *batch), Montgomery form with R = 2^256.  The port
stores limbs as int32 tensors (0..65535 in each lane); large column stacks
may be stored as int16 (the same 16 bits, reinterpreted) to halve memory.

The plain versions below compute in int64 lanes: PyTorch's CPU uint32 has no
add, shift or compare, and int64 holds every deferred-carry column exactly.
They mirror the reference's digit sequence (16-bit-digit REDC, one
conditional subtract), so results are bit-identical to
sha2cq_tpu.fields.device for every input, canonical or relaxed.

`mont_mul` dispatches through ops/cuda_field.mont_mul: a CPU tensor takes the
plain version here, a CUDA tensor launches kernel K1 (csrc/mont_mul.cu).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Sequence

import numpy as np
import torch

from . import host

NLIMB = 16          # limbs per element
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
LIMB = torch.int32  # dtype of limb tensors


def _int_to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(NLIMB)],
                    dtype=np.uint32)


@dataclass(frozen=True)
class FieldCtx:
    """Per-modulus constants (same fields as the reference's FieldCtx)."""
    p: int
    name: str
    p_limbs: np.ndarray = field(repr=False, default=None)
    n0: int = 0                 # -p^{-1} mod 2^16 (Montgomery digit constant)
    r: int = 0                  # R mod p
    r2: int = 0                 # R^2 mod p
    r_limbs: np.ndarray = field(repr=False, default=None)
    r2_limbs: np.ndarray = field(repr=False, default=None)
    wide: bool = False          # p > 2^255: REDC result may overflow 2^256

    @staticmethod
    def make(p: int, name: str) -> "FieldCtx":
        n0 = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        r = (1 << 256) % p
        r2 = (r * r) % p
        return FieldCtx(
            p=p, name=name,
            p_limbs=_int_to_limbs(p), n0=n0, r=r, r2=r2,
            r_limbs=_int_to_limbs(r), r2_limbs=_int_to_limbs(r2),
            wide=p > (1 << 255),
        )


FR = FieldCtx.make(host.FR_MOD, "Fr")
FQ = FieldCtx.make(host.FQ_MOD, "Fq")


def ctx_for(p_name: str) -> FieldCtx:
    return FR if p_name == "Fr" else FQ


def device_key(device) -> str:
    """A device's cache key: "cuda" and "cuda:<current>" are one device."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


# ------------------------- host <-> device conversion -----------------------

def _native_lib(ctx: FieldCtx, n: int):
    """native/fieldops.c when usable for this field (the C Montgomery
    conversions replace per-element Python big-int work)."""
    if ctx.name != "Fr" or n < 256:
        return None
    from .. import native_loader as NL
    return NL if NL.get_lib() is not None else None


def limbs_np(arr) -> np.ndarray:
    """A limb tensor (int32, or int16 storage) or array -> uint32 numpy."""
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu()
        if t.dtype == torch.int16:
            return t.numpy().view(np.uint16).astype(np.uint32)
        return t.numpy().astype(np.uint32)
    a = np.asarray(arr)
    if a.dtype == np.int16:
        return a.view(np.uint16).astype(np.uint32)
    return a.astype(np.uint32)


def pack(values: Sequence[int], ctx: FieldCtx, mont: bool = True,
         device=None) -> torch.Tensor:
    """ints -> int32[16, n] limb tensor (Montgomery form by default)."""
    return torch.from_numpy(np_pack(values, ctx, mont=mont).astype(np.int32)
                            ).to(device)


def pack_scalar(v: int, ctx: FieldCtx, mont: bool = True,
                device=None) -> torch.Tensor:
    """One element as a (16, 1) limb tensor."""
    return pack([v], ctx, mont=mont, device=device)


def unpack(arr, ctx: FieldCtx, mont: bool = True) -> list:
    """[16, *batch] limbs -> list of ints (flattened batch, C order)."""
    a = limbs_np(arr).reshape(NLIMB, -1)
    n = a.shape[1]
    NL = _native_lib(ctx, n)
    if NL is not None and (a <= MASK).all():
        buf = np.ascontiguousarray(a.T.astype("<u2")).view("<u8")
        # fr_vec_scale computes vals*c mod p in plain form, so the
        # Montgomery exit passes c = R^{-1} and the identity passes c = 1
        scale = pow(ctx.r, ctx.p - 2, ctx.p) if mont else 1
        NL.get_lib().fr_vec_scale(NL._u64p(buf), NL._u64p(NL.fr_buf([scale])), n)
        return NL._np_from_u64_limbs(buf)
    acc = np.zeros(n, dtype=object)
    for i in range(NLIMB):
        acc |= a[i].astype(object) << (LIMB_BITS * i)
    if mont:
        rinv = pow(ctx.r, ctx.p - 2, ctx.p)
        return [(int(v) * rinv) % ctx.p for v in acc]
    return [int(v) % ctx.p for v in acc]


def unpack_buf(arr, ctx: FieldCtx, mont: bool = True) -> np.ndarray:
    """[16, *batch] limbs -> (n, 4) canonical u64 limb buffer (the form the
    native folds, evals and MSMs consume)."""
    a = limbs_np(arr).reshape(NLIMB, -1)
    n = a.shape[1]
    NL = _native_lib(ctx, n)
    if NL is not None and (a <= MASK).all():
        buf = np.ascontiguousarray(a.T.astype("<u2")).view("<u8")
        scale = pow(ctx.r, ctx.p - 2, ctx.p) if mont else 1
        NL.get_lib().fr_vec_scale(NL._u64p(buf), NL._u64p(NL.fr_buf([scale])), n)
        return buf
    from ..native_loader import _np_u64_limbs
    return _np_u64_limbs(unpack(arr, ctx, mont=mont), 4)


def np_pack_buf(buf: np.ndarray, ctx: FieldCtx, mont: bool = True) -> np.ndarray:
    """(n, 4) canonical u64 limb buffer -> uint32[16, n] (Montgomery by
    default) without a big-int round trip."""
    n = buf.shape[0]
    NL = _native_lib(ctx, n)
    if NL is None:
        from ..native_loader import _np_from_u64_limbs
        return np_pack(_np_from_u64_limbs(buf), ctx, mont=mont)
    work = np.ascontiguousarray(buf).copy()
    if mont:
        NL.get_lib().fr_vec_scale(
            NL._u64p(work), NL._u64p(NL.fr_buf([ctx.r % ctx.p])), n)
    return np.ascontiguousarray(
        work.view("<u2").reshape(n, NLIMB).T).astype(np.uint32)


def np_pack(values: Sequence[int], ctx: FieldCtx, mont: bool = True) -> np.ndarray:
    """ints -> uint32[16, n] numpy array (Montgomery form by default)."""
    n = len(values)
    NL = _native_lib(ctx, n)
    if NL is not None:
        buf = NL._np_u64_limbs([v % ctx.p for v in values], 4)
        if mont:
            NL.get_lib().fr_vec_scale(
                NL._u64p(buf), NL._u64p(NL.fr_buf([ctx.r % ctx.p])), n)
        return np.ascontiguousarray(buf.view("<u2").reshape(n, NLIMB).T
                                    ).astype(np.uint32)
    vals = np.array([v % ctx.p for v in values], dtype=object)
    if mont:
        vals = (vals * ctx.r) % ctx.p
    arr = np.zeros((NLIMB, len(values)), dtype=np.uint32)
    for i in range(NLIMB):
        arr[i] = ((vals >> (LIMB_BITS * i)) & MASK).astype(np.uint32)
    return arr


def widen(a: torch.Tensor) -> torch.Tensor:
    """Limb tensor (int32, or int16 storage) -> int64 limb values."""
    if a.dtype == torch.int16:
        return a.to(torch.int64) & MASK
    return a.to(torch.int64)


# ------------------------------ plain kernels -------------------------------
# int64 lanes; every function returns int32 limbs.

def _carry_canonicalize(cols, nout: int):
    """Propagate carries over a list of columns -> nout 16-bit limbs.
    Returns (limbs list, final carry)."""
    out = []
    carry = None
    for i in range(nout):
        v = cols[i] if i < len(cols) else torch.zeros_like(cols[0])
        if carry is not None:
            v = v + carry
        out.append(v & MASK)
        carry = v >> LIMB_BITS
    return out, carry


def _geq(a_limbs, b_limbs):
    """a >= b over 16-bit limb lists (little-endian)."""
    ge = None
    for ai, bi in zip(a_limbs, b_limbs):
        gt_i = ai > bi
        eq_i = ai == bi
        ge = (gt_i | eq_i) if ge is None else (gt_i | (eq_i & ge))
    return ge


def _sub_limbs(a_limbs, b_limbs):
    """a - b mod 2^256 over limb lists with a borrow chain.  In int64 lanes
    a borrow is a negative difference (the reference's uint32 lanes test the
    wrapped top bit instead)."""
    out = []
    borrow = torch.zeros_like(a_limbs[0])
    for ai, bi in zip(a_limbs, b_limbs):
        v = ai - bi - borrow
        out.append(v & MASK)
        borrow = (v < 0).to(torch.int64)
    return out, borrow


def _plimbs(ctx: FieldCtx, like: torch.Tensor):
    return [torch.full_like(like, int(x)) for x in ctx.p_limbs]


def add(a, b, ctx: FieldCtx = FR):
    """(a + b) mod p (inputs canonical)."""
    a, b = torch.broadcast_tensors(widen(a), widen(b))
    s, carry = _carry_canonicalize(list(a + b), NLIMB)
    pl = _plimbs(ctx, s[0])
    d, _ = _sub_limbs(s, pl)
    need_sub = (carry > 0) | _geq(s, pl)
    return torch.stack([torch.where(need_sub, x, y)
                        for x, y in zip(d, s)]).to(LIMB)


def sub(a, b, ctx: FieldCtx = FR):
    """(a - b) mod p (inputs canonical)."""
    a, b = torch.broadcast_tensors(widen(a), widen(b))
    d, borrow = _sub_limbs(list(a), list(b))
    pl = _plimbs(ctx, d[0])
    dp, _ = _carry_canonicalize([x + y for x, y in zip(d, pl)], NLIMB)
    under = borrow > 0
    return torch.stack([torch.where(under, x, y)
                        for x, y in zip(dp, d)]).to(LIMB)


def neg(a, ctx: FieldCtx = FR):
    return sub(torch.zeros_like(a), a, ctx)


def mont_mul_plain(a, b, ctx: FieldCtx = FR):
    """Montgomery product a*b*R^{-1} mod p, the reference's algorithm:
    16x16 limb products split lo/hi into 33 deferred-carry columns, 16
    digit-wise REDC steps (base 2^16), carry sweep, one conditional
    subtract.  a < 2^256 and b < p give a canonical result."""
    a, b = torch.broadcast_tensors(widen(a), widen(b))
    batch = a.shape[1:]
    cols = torch.zeros((2 * NLIMB + 1, *batch), dtype=torch.int64,
                       device=a.device)
    for i in range(NLIMB):
        prod = a[i].unsqueeze(0) * b                    # (16, *batch)
        cols[i:i + NLIMB] += prod & MASK
        cols[i + 1:i + NLIMB + 1] += prod >> LIMB_BITS
    p = torch.as_tensor(ctx.p_limbs.astype(np.int64), device=a.device) \
        .reshape((NLIMB,) + (1,) * (a.dim() - 1))
    for i in range(NLIMB):
        m = (cols[i] * ctx.n0) & MASK
        mp = m.unsqueeze(0) * p
        cols[i:i + NLIMB] += mp & MASK
        cols[i + 1:i + NLIMB + 1] += mp >> LIMB_BITS
        cols[i + 1] += cols[i] >> LIMB_BITS
    limbs, _ = _carry_canonicalize(list(cols[NLIMB:]), NLIMB + 1)
    hi = limbs[NLIMB]
    limbs = limbs[:NLIMB]
    pl = _plimbs(ctx, limbs[0])
    d, _ = _sub_limbs(limbs, pl)
    need_sub = _geq(limbs, pl)
    if ctx.wide:
        need_sub = need_sub | (hi > 0)
    return torch.stack([torch.where(need_sub, x, y)
                        for x, y in zip(d, limbs)]).to(LIMB)


def mont_mul(a, b, ctx: FieldCtx = FR):
    """Montgomery product; CPU tensors take the plain version, CUDA tensors
    kernel K1 (ops/cuda_field.mont_mul)."""
    from ..ops import cuda_field
    return cuda_field.mont_mul(a, b, ctx)

