"""Field kernels of the port (counterpart of sha2cq_tpu/ops/pallas_field.py).

Three wrappers, each with its plain PyTorch version and a launch counter:

* K1 `mont_mul` replaces `pallas_field.pallas_mont_mul` (and the jnp
  `fields.device.mont_mul` the reference's h path calls): elementwise
  Montgomery product of (16, *batch) limb tensors, with the second operand
  either the same shape, a (16, 1) scalar, or a (16, 1, X) row broadcast
  over the middle axis.  A wide context (p > 2^255: secp256k1's Fp and Fq)
  launches K1w, the kernel's instance that keeps REDC's overflow word (the
  reference's `ctx.wide` branch of fields.device.mont_mul).
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
plonk/h_vm.py, the MSM's kernels K5 and K6 theirs in ops/msm.py, the G1
kernels K7 and K8 of the CQ tables' FK theirs in curves/device.py; their
counters live here with the others.)
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict

import torch

from ..fields import device as D
from ..fields.device import FR, LIMB, MASK, NLIMB
from . import kernels as K

NDIG = 32
K2_TILE, K2_MINOR, K2_MAJOR, K2_SCALAR = range(4)   # csrc/planes_to_limbs.cu's K2Mode

# Launch counts, one per kernel: incremented exactly where a wrapper calls
# its kernel's C entry, once a call (count_launch).  Two entries launch
# more than one CUDA kernel a call: K4's (one k4_pass a pass,
# ops/ntt.k4_passes), K6's (k6_partials_kernel, then
# k6_combine_kernel) and K8's (one stage a launch).  shard_launches[i] counts the launches made while
# mesh shard i's work runs (parallel/distributed.shards).
launches = {"mont_mul": 0, "mont_mul_wide": 0, "planes_to_limbs_mul": 0,
            "h_vm_run": 0, "ntt_radix2": 0, "msm_bucket_sums": 0,
            "msm_window_reduce": 0, "g1_scalar_mul": 0, "g1_ntt": 0}
shard_launches: Dict[int, Dict[str, int]] = {}
_shard = threading.local()


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0
    shard_launches.clear()


def count_launch(name: str) -> None:
    """One launch of kernel `name` (and of the current mesh shard's)."""
    launches[name] += 1
    i = getattr(_shard, "index", None)
    if i is not None:
        shard_launches.setdefault(i, dict.fromkeys(launches, 0))[name] += 1


@contextlib.contextmanager
def in_shard(i: int):
    """Count this thread's launches for mesh shard i as well."""
    prev = getattr(_shard, "index", None)
    _shard.index = i
    try:
        yield
    finally:
        _shard.index = prev


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
    as the reference: a < 2^256, b < p gives a canonical result).  K1 for
    p < 2^255, K1w for a wide context."""
    if not a.is_cuda and not b.is_cuda:
        return D.mont_mul_plain(a, b, ctx)
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
    name, entry = (("mont_mul_wide", lib.k1_mont_mul_wide) if ctx.wide
                   else ("mont_mul", lib.k1_mont_mul))
    count_launch(name)
    K.check(entry(a.data_ptr(), b.data_ptr(), out.data_ptr(), n, b_stride,
                  b_mod, p8, n0, K.stream_ptr(a)), name)
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


def k2_mu(ctx) -> int:
    """floor(2^288 / p), K2's quotient estimate (csrc/planes_to_limbs.cu);
    its bounds hold for 2^248 < p < 2^254 (Fr, Fq)."""
    if ctx.wide or not 1 << 248 < ctx.p < 1 << 254:
        raise NotImplementedError(
            f"K2's one-step reduction needs 2^248 < p < 2^254 ({ctx.name})")
    return (1 << 288) // ctx.p


def _umul64hi(t: torch.Tensor, mu: int) -> torch.Tensor:
    """floor(t * mu / 2^64) for int64 lanes t < 2^56 and mu < 2^48 (CUDA's
    __umul64hi on K2's operands), exact: schoolbook on 16-bit digits, so
    every column sum stays below 2^35."""
    if not 0 <= mu < 1 << 48:
        raise ValueError("mu must be below 2^48")
    d = [(t >> (16 * i)) & 0xFFFF for i in range(4)]
    m = [(mu >> (16 * j)) & 0xFFFF for j in range(3)]

    def column(pos):
        return sum(d[i] * m[pos - i] for i in range(4) if 0 <= pos - i < 3)

    carry = torch.zeros_like(t)
    for pos in range(4):          # floor of the columns below 2^64
        carry = (carry + column(pos)) >> 16
    return carry + column(4) + (column(5) << 16)


def planes_to_words_plain(O: torch.Tensor, ctx=FR) -> torch.Tensor:
    """Plain mirror of K2's word form (csrc/planes_to_limbs.cu), in int64
    lanes: (32, M, X) nonnegative int32 planes -> (16, M, X) limbs of
    v = V - q p, where V = sum_q plane[q] 2^{8q} is built in nine 32-bit
    words from four funnel-shifted rows and q = floor((V >> 224) mu / 2^64).
    v has V's residue and is below 2^256 (not the reference's relaxed
    value: planes_to_limbs_plain is that)."""
    mu = k2_mu(ctx)
    pl = O.to(torch.int64)
    W = 0xFFFFFFFF
    V = [pl[4 * w] for w in range(8)] + [torch.zeros_like(pl[0])]
    for b in range(1, 4):
        A = [(pl[b] << (8 * b)) & W]
        A += [((pl[4 * w + b] << (8 * b)) & W) | (pl[4 * w - 4 + b] >> (32 - 8 * b))
              for w in range(1, 8)]
        A.append(pl[28 + b] >> (32 - 8 * b))
        carry = 0
        for w in range(9):                       # one carry chain
            s = V[w] + A[w] + carry
            V[w], carry = s & W, s >> 32
    q = _umul64hi((V[8] << 32) | V[7], mu)
    pw = [(ctx.p >> (32 * i)) & W for i in range(8)]
    lo = [(q * pw[i]) & W for i in range(8)]
    hi = [(q * pw[i]) >> 32 for i in range(8)]
    borrow = 0
    for i in range(9):                           # V -= lo
        d = V[i] - (lo[i] if i < 8 else 0) - borrow
        V[i], borrow = d & W, (d < 0).to(torch.int64)
    borrow = 0
    for i in range(1, 9):                        # V -= hi << 32
        d = V[i] - hi[i - 1] - borrow
        V[i], borrow = d & W, (d < 0).to(torch.int64)
    if bool((V[8] != 0).any()):
        raise AssertionError("K2's reduction left v >= 2^256")
    return torch.stack([V[i // 2] >> (16 * (i % 2)) & MASK
                        for i in range(NLIMB)]).to(LIMB)


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
    """Plain version of K2: planes -> relaxed limbs (the reference's form)
    -> mont_mul by the multiplier, broadcast as the mode says."""
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
    if M * X >= 1 << 31:
        raise ValueError(f"K2 indexes in 32 bits: M*X = {M * X}")
    mls, mms, div, mod = _mult_index(mult, M, X, mult_is_tile, mult_minor,
                                     mult_major)
    mode, period = ((K2_SCALAR, 1) if not mult_is_tile else
                    (K2_MINOR, mod) if mult_minor else
                    (K2_MAJOR, div) if mult_major else (K2_TILE, 1))
    mu = k2_mu(ctx)
    O = O.contiguous()
    mult = as_limbs32(mult).contiguous()
    if mult.device != O.device:
        raise ValueError("planes and multiplier on different devices")
    out = torch.empty((NLIMB, M, X), dtype=LIMB, device=O.device)
    if M * X == 0:
        return out
    p8, n0 = K.field_words(ctx)
    lib = K.get_lib()
    count_launch("planes_to_limbs_mul")
    K.check(lib.k2_planes_to_limbs_mul(
        O.data_ptr(), mult.data_ptr(), out.data_ptr(), M, X, mode, mls, mms,
        period, p8, n0, mu, K.stream_ptr(O)), "k2_planes_to_limbs_mul")
    return out


# --------------------------------- K4 ---------------------------------------

def twiddle_words(twiddles: torch.Tensor) -> torch.Tensor:
    """(n/2, 8) int32: the 32-bit words of each twiddle of a (16, n/2) limb
    table in one 32-byte row, K4's layout (ops/ntt.twiddle_table keeps them
    beside each table it builds, as its `k4_words`)."""
    t = twiddles.to(torch.int64)
    w = (t[0::2] & MASK) | ((t[1::2] & MASK) << 16)            # (8, n/2)
    return torch.where(w >= 1 << 31, w - (1 << 32), w).to(LIMB).t().contiguous()


def ntt_radix2(a: torch.Tensor, twiddles: torch.Tensor, k: int,
               ctx=FR) -> torch.Tensor:
    """Radix-2 NTT along the last axis (size 2^k) of a CUDA (16, ..., n)
    limb tensor (int32, or int16 storage) with the (16, n/2) Montgomery
    twiddle table: kernel K4, one launch per pass of ops/ntt.k4_passes
    (one up to k = 11, two up to k = 16, three up to k = 24).  Returns
    (16, ..., n) int32 limbs.  The CPU version is
    ops/ntt.ntt_last_axis_plain."""
    if not a.is_cuda:
        raise ValueError("ntt_radix2 launches K4 and takes CUDA tensors; "
                         "CPU tensors take ops/ntt.ntt_last_axis_plain")
    if ctx.wide:
        raise NotImplementedError("K4 covers p < 2^255 (Fr, Fq)")
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
    from .ntt import k4_pass_array
    cols = a.numel() // (NLIMB << k)
    npass, passes = k4_pass_array(k, cols)
    words = getattr(twiddles, "k4_words", None)
    if words is None:                 # a table not from ops/ntt.twiddle_table
        words = twiddle_words(twiddles)
    out = torch.empty(a.shape, dtype=LIMB, device=a.device)
    p8, n0 = K.field_words(ctx)
    lib = K.get_lib()
    count_launch("ntt_radix2")
    K.check(lib.k4_ntt_radix2(
        a.data_ptr(), 1 if a.dtype == torch.int16 else 0, out.data_ptr(),
        words.data_ptr(), cols, k, npass, passes, p8, n0, K.stream_ptr(a)),
        "k4_ntt_radix2")
    return out
