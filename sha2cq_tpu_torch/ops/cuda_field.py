"""Field kernels of the port (counterpart of sha2cq_tpu/ops/pallas_field.py).

Three wrappers, each with its plain PyTorch version and a launch counter:

* K1 `mont_mul` replaces `pallas_field.pallas_mont_mul` (and the jnp
  `fields.device.mont_mul` the reference's h path calls): elementwise
  Montgomery product of (16, *batch) limb tensors, with the second operand
  either the same shape, a (16, 1) scalar, or a (16, 1, X) row broadcast
  over the middle axis.
* K2 `planes_to_limbs_mul` replaces `pallas_field.planes_to_limbs_mul`: the
  digit-matmul NTT's fused epilogue, (32, M, X) int32 digit planes ->
  (16, M, X) canonical limbs multiplied by a twiddle tile, a periodic
  twiddle block or a broadcast scalar.
* K4 `ntt_radix2` replaces the jnp butterflies of `ntt._ntt_core` /
  `ntt.ntt_last_axis`: the radix-2 NTT along the last axis of a
  (16, ..., n) limb tensor (plain version: ops/ntt.ntt_last_axis_plain).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  There is no shape gate: the kernels index every operand directly
and mask the ragged edge.  (The h VM's kernel K3 has its wrapper in
plonk/h_vm.py; its counter lives here with the others.)
"""
from __future__ import annotations

import torch

from ..fields import device as D
from ..fields.device import FR, LIMB, MASK, NLIMB
from . import kernels as K

NDIG = 32

# Launch counts, one per kernel: incremented exactly where a kernel launches.
launches = {"mont_mul": 0, "planes_to_limbs_mul": 0, "h_vm_run": 0,
            "ntt_radix2": 0}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def as_limbs32(t: torch.Tensor) -> torch.Tensor:
    """int32 limbs from int32 or int16 storage."""
    if t.dtype == torch.int16:
        return t.to(LIMB) & MASK
    if t.dtype != LIMB:
        raise TypeError(f"limb tensor must be int32 or int16, got {t.dtype}")
    return t


# --------------------------------- K1 ---------------------------------------

def mont_mul(a: torch.Tensor, b: torch.Tensor, ctx=FR) -> torch.Tensor:
    """Montgomery product a*b*R^{-1} mod p of limb tensors (same contract
    as the reference: a < 2^256, b < p gives a canonical result)."""
    if not a.is_cuda and not b.is_cuda:
        return D.mont_mul_plain(a, b, ctx)
    if ctx.wide:
        raise NotImplementedError(
            "K1 covers p < 2^255 (Fr, Fq); the wide-modulus variant for "
            "secp256k1 is not ported (ROADMAP)")
    a, b = as_limbs32(a), as_limbs32(b)
    if a.shape[:1] != (NLIMB,) or b.shape[:1] != (NLIMB,):
        raise ValueError(f"limb tensors are (16, ...), got {tuple(a.shape)} "
                         f"and {tuple(b.shape)}")
    if a.numel() < b.numel():
        a, b = b, a           # a*b*R^{-1} is symmetric in its operands
    batch = a.shape[1:]
    n = a[0].numel()
    if b.shape[1:] == batch:
        b_stride, b_mod = n, n
    elif b[0].numel() == 1:
        b_stride, b_mod = 1, 1
    elif a.dim() == 3 and b.dim() == 3 and b.shape[1] == 1 and \
            b.shape[2] == a.shape[2]:
        b_stride, b_mod = b.shape[2], b.shape[2]
    else:
        b = b.expand(NLIMB, *batch)
        b_stride, b_mod = n, n
    a, b = a.contiguous(), b.contiguous()
    if a.device != b.device:
        raise ValueError("mont_mul operands on different devices")
    out = torch.empty((NLIMB, *batch), dtype=LIMB, device=a.device)
    if n == 0:
        return out
    p8, n0 = K.field_words(ctx)
    lib = K.get_lib()
    launches["mont_mul"] += 1
    K.check(lib.k1_mont_mul(a.data_ptr(), b.data_ptr(), out.data_ptr(), n,
                            b_stride, b_mod, p8, n0, K.stream_ptr(a)),
            "k1_mont_mul")
    return out


# --------------------------------- K2 ---------------------------------------

def fold_consts(ctx):
    """16-bit limbs of 2^{8q} mod p for q = 32, 33, 34, then R mod p."""
    rows = []
    for q in (32, 33, 34):
        v = (1 << (8 * q)) % ctx.p
        rows.append([(v >> (16 * j)) & MASK for j in range(NLIMB)])
    rows.append([(ctx.r >> (16 * j)) & MASK for j in range(NLIMB)])
    return rows


def _sweep(cols):
    out = []
    carry = torch.zeros_like(cols[0])
    for j in range(NLIMB):
        v = cols[j] + carry
        out.append(v & MASK)
        carry = v >> 16
    return out, carry


def planes_to_limbs_plain(O: torch.Tensor, ctx=FR) -> torch.Tensor:
    """(32, m, B) nonneg int32 digit planes -> (16, m, B) limbs of the same
    value mod p in the relaxed form (< 2^256), the reference's
    mxu_ntt._planes_to_limbs step for step (int64 lanes)."""
    Ou = O.to(torch.int64)
    C = torch.zeros((NDIG + 4, *O.shape[1:]), dtype=torch.int64, device=O.device)
    for u in range(4):
        C[u:u + NDIG] += (Ou >> (8 * u)) & 0xFF
    cols = [C[2 * t] + (C[2 * t + 1] << 8) for t in range(NLIMB)]
    consts = fold_consts(ctx)
    excess = torch.zeros_like(cols[0])
    for qi in range(3):
        h = C[NDIG + qi]
        for j in range(NLIMB):
            prod = h * consts[qi][j]
            cols[j] = cols[j] + (prod & MASK)
            if j + 1 < NLIMB:
                cols[j + 1] = cols[j + 1] + (prod >> 16)
            else:
                excess = excess + (prod >> 16)
    limbs, carry = _sweep(cols)
    excess = excess + carry
    for _ in range(5):
        cols = list(limbs)
        for j in range(NLIMB):
            prod = excess * consts[3][j]
            cols[j] = cols[j] + (prod & MASK)
            if j + 1 < NLIMB:
                cols[j + 1] = cols[j + 1] + (prod >> 16)
            else:
                nxt = prod >> 16
        limbs, carry = _sweep(cols)
        excess = nxt + carry
    return torch.stack(limbs).to(LIMB)


def _mult_index(mult, M, X, mult_is_tile, mult_minor, mult_major):
    """(limb stride, m stride, div, mod) so that the multiplier of output
    element (m, x) is mult[l, m, (x // div) % mod]."""
    if not mult_is_tile:
        if mult.numel() != NLIMB:
            raise ValueError("a scalar multiplier has 16 limbs")
        return 1, 0, 1, 1
    if mult_minor:                 # x = b*m1 + t1 -> column x % m1
        if mult.shape != (NLIMB, M, mult_minor):
            raise ValueError(f"mult_minor: mult {tuple(mult.shape)} != (16, {M}, {mult_minor})")
        return M * mult_minor, mult_minor, 1, mult_minor
    if mult_major:                 # x = t1*B + b -> column x // B
        if X % mult_major or mult.shape != (NLIMB, M, X // mult_major):
            raise ValueError(f"mult_major: mult {tuple(mult.shape)} does not tile X={X}")
        return M * (X // mult_major), X // mult_major, mult_major, X // mult_major
    if mult.shape != (NLIMB, M, X):
        raise ValueError(f"tile mult {tuple(mult.shape)} != (16, {M}, {X})")
    return M * X, X, 1, X


def planes_to_limbs_mul_plain(O, mult, ctx=FR, mult_is_tile=True,
                              mult_minor=0, mult_major=0):
    """Plain version of K2: planes -> relaxed limbs -> mont_mul by the
    multiplier, broadcast as the mode says."""
    M, X = O.shape[1], O.shape[2]
    _mult_index(mult, M, X, mult_is_tile, mult_minor, mult_major)
    limbs = planes_to_limbs_plain(O, ctx)
    if not mult_is_tile:
        m = mult.reshape(NLIMB, 1, 1)
    elif mult_minor:
        m = mult.repeat(1, 1, X // mult_minor)
    elif mult_major:
        m = mult.repeat_interleave(mult_major, dim=2)
    else:
        m = mult
    return D.mont_mul_plain(limbs, m, ctx)


def planes_to_limbs_mul(O: torch.Tensor, mult: torch.Tensor, ctx=FR,
                        mult_is_tile: bool = True, mult_minor: int = 0,
                        mult_major: int = 0) -> torch.Tensor:
    """(32, M, X) int32 digit planes -> (16, M, X) canonical Montgomery
    limbs, multiplied by `mult` on the way out.

    mult_is_tile=False: mult is one (16,)/(16, 1) scalar for every element.
    mult_is_tile=True:  mult is (16, M, X) per element, or
      mult_minor=m1: (16, M, m1) with x = b*m1 + t1 (reads column x % m1),
      mult_major=B:  (16, M, X/B) with x = t1*B + b (reads column x // B),
    so a periodic twiddle block is never broadcast into memory."""
    if not O.is_cuda:
        return planes_to_limbs_mul_plain(O, mult, ctx, mult_is_tile,
                                         mult_minor, mult_major)
    if O.dtype != torch.int32 or O.dim() != 3 or O.shape[0] != NDIG:
        raise ValueError(f"planes must be (32, M, X) int32, got "
                         f"{tuple(O.shape)} {O.dtype}")
    M, X = O.shape[1], O.shape[2]
    mls, mms, div, mod = _mult_index(mult, M, X, mult_is_tile, mult_minor,
                                     mult_major)
    O = O.contiguous()
    mult = as_limbs32(mult).contiguous()
    if mult.device != O.device:
        raise ValueError("planes and multiplier on different devices")
    out = torch.empty((NLIMB, M, X), dtype=LIMB, device=O.device)
    if M * X == 0:
        return out
    p8, n0 = K.field_words(ctx)
    folds = K.u32_array([v for row in fold_consts(ctx) for v in row])
    lib = K.get_lib()
    launches["planes_to_limbs_mul"] += 1
    K.check(lib.k2_planes_to_limbs_mul(
        O.data_ptr(), mult.data_ptr(), out.data_ptr(), M, X, mls, mms, div,
        mod, p8, n0, folds, K.stream_ptr(O)), "k2_planes_to_limbs_mul")
    return out


# --------------------------------- K4 ---------------------------------------

def ntt_radix2(a: torch.Tensor, twiddles: torch.Tensor, k: int,
               ctx=FR) -> torch.Tensor:
    """Radix-2 NTT along the last axis (size 2^k) of a CUDA (16, ..., n)
    limb tensor (int32, or int16 storage) with the (16, n/2) Montgomery
    twiddle table: kernel K4, one launch per stage.  Returns (16, ..., n)
    int32 limbs.  The CPU version is ops/ntt.ntt_last_axis_plain."""
    if not a.is_cuda:
        raise ValueError("ntt_radix2 launches K4 and takes CUDA tensors; "
                         "CPU tensors take ops/ntt.ntt_last_axis_plain")
    if not 0 <= k <= 30:
        raise ValueError(f"ntt_radix2: k = {k} outside 0..30")
    n = 1 << k
    if a.dim() < 2 or a.shape[0] != NLIMB or a.shape[-1] != n:
        raise ValueError(f"ntt_radix2: limbs must be (16, ..., {n}), got "
                         f"{tuple(a.shape)}")
    if a.dtype not in (torch.int16, LIMB):
        raise TypeError(f"ntt_radix2: limb dtype {a.dtype}")
    if twiddles.dtype != LIMB or twiddles.shape != (NLIMB, max(n // 2, 1)):
        raise ValueError(f"ntt_radix2: twiddles must be (16, {max(n // 2, 1)}) "
                         f"int32, got {tuple(twiddles.shape)} {twiddles.dtype}")
    if twiddles.device != a.device:
        raise ValueError("ntt_radix2: limbs and twiddles on different devices")
    a = a.contiguous()
    if k == 0 or a.numel() == 0:
        return as_limbs32(a).clone()
    twiddles = twiddles.contiguous()
    out = torch.empty(a.shape, dtype=LIMB, device=a.device)
    p8, n0 = K.field_words(ctx)
    lib = K.get_lib()
    launches["ntt_radix2"] += 1
    K.check(lib.k4_ntt_radix2(
        a.data_ptr(), 1 if a.dtype == torch.int16 else 0, out.data_ptr(),
        twiddles.data_ptr(), a[0].numel() // n, k, p8, n0, K.stream_ptr(a)),
        "k4_ntt_radix2")
    return out
