"""Digit-matmul NTT of the port (counterpart of sha2cq_tpu/ops/mxu_ntt.py).

The algorithm is the reference's, value for value: a size-m DFT (m <= 512)
of field elements is ONE int8 matrix product of a (32m x 32m) digit matrix
(entry [(s, i), (j, b)] = byte_s(omega^{ij} * 2^{8b} mod p) - 128) with the
(32m x B) signed digit columns of the inputs, which yields 32 int32 output
digit planes exactly; larger sizes use the four-step split n = m1 * 512
recursively, with the twiddle multiply fused into the next epilogue.

On the card the int8 product is `torch._int_mm` (cuBLASLt; the reference
leaves the same product to XLA's dot_general, outside any Pallas kernel) and
every level's epilogue -- planes -> limbs -> twiddle or scale multiply -- is
kernel K2 (ops/cuda_field.planes_to_limbs_mul).  On the CPU the same calls
run the plain versions.  Unlike the reference's TPU layout, the twiddle of a
batched level is indexed in place (mult_major), so no level transposes its
input to reach a periodic twiddle block.

Plans (digit matrices, twiddle tensors) are built where they are used, at
the reference's thresholds: for a CUDA device a digit matrix with m >= 64
and an Fr twiddle tensor with m2*m1 >= 2^16 are built on the card from one
row of powers (row scans of Montgomery multiplies, kernel K1, and 32
byte-shift passes), the reference's _digit_matrix_build_jit /
_twiddle_build_jit, instead of a 268 MB host build and copy; every other
plan is built on the host in numpy (native Fr kernels, the reference's npz
cache format).  Both routes give bit-identical tensors: every value is a
canonical field element, and canonical forms are unique.
"""
from __future__ import annotations

import functools
import hashlib
import os
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..fields import device as D
from ..fields.device import FR, LIMB, NLIMB
from . import cuda_field as CF

NDIG = 32            # 8-bit digits per 256-bit element
MAX_MATMUL = 512     # largest DFT done as a single matmul


def auto_max_m(n: int) -> int:
    """Plan width, as in the reference: 1024 for n >= 2^20, else 512."""
    return 1024 if n >= (1 << 20) else MAX_MATMUL


def _cache_dir() -> str:
    """The reference's npz format in a directory of the port's own: the
    reference writes its cache files in place (not atomically), so a port
    process must never read a file the reference may be writing."""
    return os.path.join(
        os.path.expanduser(os.environ.get("SHA2CQ_CACHE", "~/.cache/sha2cq_jax")),
        "mxu_ntt_torch")


class NttPlan(NamedTuple):
    """Tensors for one (n, omega) NTT."""
    base_mat: torch.Tensor       # (32*m2, 32*m2) int8 -- shared inner DFT
    base_rowsum: torch.Tensor    # (32*m2,) int32
    res_mat: torch.Tensor        # residual outer DFT matrix
    res_rowsum: torch.Tensor
    twiddles: Tuple[torch.Tensor, ...]   # per level: (16, m2, m1) Montgomery


# Card-route thresholds (the reference's, mxu_ntt.py:169 and :203).
DEVICE_MATRIX_MIN_M = 64
DEVICE_TWIDDLE_MIN = 1 << 16


# ------------------------- host-side precomputation --------------------------

def _digit_matrix_bigint(m: int, omega: int, p: int):
    """The reference's Python big-int build (any omega)."""
    w_pows = np.empty(m, dtype=object)
    cur = 1
    for j in range(m):
        w_pows[j] = cur
        cur = cur * omega % p
    mat = np.empty((NDIG * m, m * NDIG), dtype=np.int8)
    row = np.ones(m, dtype=object)
    buf = np.empty((m, NDIG, NDIG), dtype=np.uint8)  # [j, b, s] digits
    for i in range(m):
        v = row.copy()
        for b in range(NDIG):
            for j in range(m):
                buf[j, b] = np.frombuffer(
                    int(v[j]).to_bytes(NDIG, "little"), dtype=np.uint8)
            if b < NDIG - 1:
                v = (v << 8) % p
        mat[i::m, :] = (buf.transpose(2, 0, 1).reshape(NDIG, m * NDIG)
                        .astype(np.int16) - 128).astype(np.int8)
        row = row * w_pows % p
    return mat


def _digit_matrix_native(m: int, omega: int, p: int):
    """The same matrix through the native Fr kernels, for an m-th root of
    unity: W[i, j] = omega^{(i*j) mod m} is a gather of the m powers, and
    the 32 byte shifts are 31 in-place `fr_vec_scale(., 256)` passes over
    the (m*m, 4) u64 buffer, whose little-endian bytes are the digits.
    Seconds instead of the big-int build's minutes at m = 512."""
    from .. import native_loader as NL
    lib = NL.get_lib()
    pows = [1] * m
    for j in range(1, m):
        pows[j] = pows[j - 1] * omega % p
    idx = (np.arange(m)[:, None] * np.arange(m)[None, :]) % m
    V = np.ascontiguousarray(NL.fr_buf(pows)[idx.reshape(-1)])  # [(i, j), 4]
    mat = np.empty((NDIG, m, m, NDIG), dtype=np.int8)            # [s, i, j, b]
    c256 = NL.fr_buf([256])
    for b in range(NDIG):
        digits = V.view(np.uint8).reshape(m, m, NDIG)            # [i, j, s]
        mat[:, :, :, b] = (np.moveaxis(digits, 2, 0).astype(np.int16)
                           - 128).astype(np.int8)
        if b < NDIG - 1:
            lib.fr_vec_scale(NL._u64p(V), NL._u64p(c256), m * m)
    return mat.reshape(NDIG * m, m * NDIG)


def _dft_digit_matrix_np(m: int, omega: int, p: int):
    """(32m, 32m) int8 digit matrix + (32m,) int32 row sums for the size-m
    DFT, cached on disk (npz, the reference's key and format; the write is
    atomic, so concurrent processes never read a partial file)."""
    from ..fields.host import FR_MOD
    from .. import native_loader as NL
    d = _cache_dir()
    os.makedirs(d, exist_ok=True)
    tag = f"w{m}_{omega % p:x}_{p:x}"
    path = os.path.join(d, hashlib.sha256(tag.encode()).hexdigest()[:24] + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["mat"], z["rowsum"]
    if p == FR_MOD and pow(omega, m, p) == 1 and NL.get_lib() is not None:
        mat = _digit_matrix_native(m, omega, p)
    else:
        mat = _digit_matrix_bigint(m, omega, p)
    rowsum = mat.sum(axis=1, dtype=np.int32)
    tmp = f"{path}.{os.getpid()}.tmp.npz"
    np.savez(tmp, mat=mat, rowsum=rowsum)
    os.replace(tmp, path)
    return mat, rowsum


def _digit_matrix_host(m: int, omega: int, ctx):
    mat, rowsum = _dft_digit_matrix_np(m, omega, ctx.p)
    return torch.from_numpy(np.ascontiguousarray(mat)), \
        torch.from_numpy(np.ascontiguousarray(rowsum))


def _twiddle_tensor_host(omega: int, m2: int, m1: int, ctx) -> torch.Tensor:
    """(16, m2, m1) Montgomery-form T[k2, t1] = omega^{k2*t1}, big ints."""
    p = ctx.p
    w_t1 = np.empty(m1, dtype=object)
    cur = 1
    for j in range(m1):
        w_t1[j] = cur
        cur = cur * (omega % p) % p
    rows = np.empty((m2, m1), dtype=object)
    row = np.ones(m1, dtype=object)
    for k2 in range(m2):
        rows[k2] = row
        row = row * w_t1 % p
    packed = D.np_pack([int(x) for x in rows.reshape(-1)], ctx)
    return torch.from_numpy(packed.reshape(NLIMB, m2, m1).astype(np.int32))


# --------------------------- on-device precomputation ------------------------

def _row_scan(first: torch.Tensor, step_row: torch.Tensor, rows: int,
              ctx) -> torch.Tensor:
    """(16, rows, m) tensor whose row i is first * step^i (Montgomery
    products; step_row (16, m) in Montgomery form, so each row keeps the
    form of `first`).  Doubling: rows [h, 2h) are rows [0, h) times the
    Montgomery row step^h, so log2(rows) launches of K1 on a card."""
    m = step_row.shape[1]
    out = torch.empty((NLIMB, rows, m), dtype=LIMB, device=step_row.device)
    out[:, 0] = first
    done, power = 1, step_row                   # power = step^done
    while done < rows:
        h = min(done, rows - done)
        out[:, done:done + h] = D.mont_mul(out[:, :h], power[:, None, :], ctx)
        done += h
        if done < rows:
            power = D.mont_mul(power, power, ctx)
    return out


def dft_digit_matrix_dev(m: int, omega: int, ctx, device):
    """The (32m, 32m) int8 digit matrix and its (32m,) int32 row sums built
    on `device` from the (16, m) row [omega^j R]_j, bit-identical to the host
    build (the reference's _digit_matrix_build_jit): W[i, j] = omega^{ij} in
    standard form by a row scan of Montgomery multiplies (standard times
    Montgomery stays standard), then 32 byte-shift passes, each a
    Montgomery multiply by [256 R] (i.e. times 256 mod p) whose two 8-bit
    halves of each 16-bit limb are digit planes s = 2t, 2t + 1."""
    p = ctx.p
    pows = [1] * m
    for j in range(1, m):
        pows[j] = pows[j - 1] * omega % p
    wm_row = D.pack(pows, ctx, mont=True, device=device)        # omega^j R
    c256 = D.pack_scalar(256 * ctx.r % p, ctx, mont=False,
                         device=device).reshape(NLIMB, 1, 1)
    one = torch.zeros((NLIMB, m), dtype=LIMB, device=device)
    one[0] = 1                                                 # standard 1
    v = _row_scan(one, wm_row, m, ctx)                         # (16, i, j)
    mat = torch.empty((NDIG, m, m, NDIG), dtype=torch.int8, device=device)
    for b in range(NDIG):                                      # [s, i, j, b]
        planes = torch.stack([v & 0xFF, (v >> 8) & 0xFF], dim=1)
        mat[..., b] = (planes.reshape(NDIG, m, m) - 128).to(torch.int8)
        if b < NDIG - 1:
            v = D.mont_mul(v, c256, ctx)
    mat = mat.reshape(NDIG * m, m * NDIG)
    return mat, mat.sum(dim=1, dtype=torch.int32)


def twiddle_tensor_dev(omega: int, m2: int, m1: int, ctx, device):
    """(16, m2, m1) Montgomery T[k2, t1] = omega^{k2*t1} R built on `device`
    from the (16, m1) row [omega^{t1} R] by a row scan of Montgomery
    multiplies (the reference's _twiddle_build_jit), bit-identical to the
    host build."""
    p = ctx.p
    pows = [1] * m1
    for j in range(1, m1):
        pows[j] = pows[j - 1] * omega % p
    wm_row = D.pack(pows, ctx, device=device)
    one = torch.as_tensor(ctx.r_limbs.astype(np.int32), device=device)
    return _row_scan(one[:, None].expand(NLIMB, m1), wm_row, m2, ctx)


# ----------------------------------- plans -----------------------------------

@functools.lru_cache(maxsize=16)
def _dft_digit_matrix(m: int, omega: int, p_name: str, device: str):
    ctx = D.ctx_for(p_name)
    omega %= ctx.p
    if torch.device(device).type == "cuda" and m >= DEVICE_MATRIX_MIN_M:
        return dft_digit_matrix_dev(m, omega, ctx, device)
    mat, rowsum = _digit_matrix_host(m, omega, ctx)
    return mat.to(device), rowsum.to(device)


@functools.lru_cache(maxsize=32)
def _twiddle_tensor(omega: int, m2: int, m1: int, p_name: str,
                    device: str) -> torch.Tensor:
    ctx = D.ctx_for(p_name)
    omega %= ctx.p
    if torch.device(device).type == "cuda" and ctx.name == "Fr" and \
            m2 * m1 >= DEVICE_TWIDDLE_MIN:
        return twiddle_tensor_dev(omega, m2, m1, ctx, device)
    return _twiddle_tensor_host(omega, m2, m1, ctx).to(device)


def plan_on(n: int, omega: int, device, p_name: str = "Fr",
            max_m: int = MAX_MATMUL):
    """The plan for a size-n NTT at omega, its tensors on `device`: built
    there (a CUDA device, by the thresholds above) or on the host and
    copied, once per device.  Returns (NttPlan, res_omega): res_omega is not
    None when the residual level (m <= 8) runs as butterflies instead of a
    digit matmul."""
    return _get_plan(n, omega % D.ctx_for(p_name).p, p_name, max_m,
                     D.device_key(device))


def get_plan(n: int, omega: int, p_name: str = "Fr",
             max_m: int = MAX_MATMUL):
    """The host (CPU tensor) plan, as the reference's get_plan."""
    return plan_on(n, omega, "cpu", p_name, max_m)


@functools.lru_cache(maxsize=64)
def _get_plan(n: int, omega: int, p_name: str, max_m: int, device: str):
    ctx = D.ctx_for(p_name)
    twiddles = []
    m, w = n, omega
    base = None
    while m > max_m:
        m2 = max_m
        m1 = m // m2
        if base is None:
            base = _dft_digit_matrix(m2, pow(w, m1, ctx.p), ctx.name, device)
        twiddles.append(_twiddle_tensor(w, m2, m1, ctx.name, device))
        m, w = m1, pow(w, m2, ctx.p)
    if m <= 8 and twiddles:
        return NttPlan(base_mat=base[0], base_rowsum=base[1],
                       res_mat=base[0], res_rowsum=base[1],
                       twiddles=tuple(twiddles)), w
    res = _dft_digit_matrix(m, w, ctx.name, device)
    if base is None:
        base = res
    return NttPlan(base_mat=base[0], base_rowsum=base[1],
                   res_mat=res[0], res_rowsum=res[1],
                   twiddles=tuple(twiddles)), None


# ------------------------------ device pipeline ------------------------------

def _to_digit_cols(a: torch.Tensor) -> torch.Tensor:
    """(16, m, B) limbs -> (m*32, B) int8 digit columns, offset -128."""
    m, B = a.shape[1], a.shape[2]
    a = CF.as_limbs32(a)
    dig = torch.stack([a & 0xFF, (a >> 8) & 0xFF], dim=1)       # (16, 2, m, B)
    dig = dig.reshape(NDIG, m, B).transpose(0, 1).reshape(m * NDIG, B)
    return (dig - 128).to(torch.int8)


def _dft_planes(a: torch.Tensor, mat: torch.Tensor,
                rowsum: torch.Tensor) -> torch.Tensor:
    """The int8 matmul core: (16, m, B) limbs -> (32, m, B) nonneg int32
    digit planes, offset corrections applied.  cuBLASLt's int8 GEMM wants
    the column count a multiple of 8: pad with zero columns and drop them."""
    m, B = a.shape[1], a.shape[2]
    XB = _to_digit_cols(a)                                     # (32m, B)
    S_x = XB.sum(dim=0, dtype=torch.int32)                     # (B,)
    Bp = -(-B // 8) * 8
    if Bp != B:
        XB = torch.nn.functional.pad(XB, (0, Bp - B))
    MM = torch._int_mm(mat, XB.contiguous())
    if Bp != B:
        MM = MM[:, :B]
    K = m * NDIG
    O = MM + (128 * rowsum)[:, None] + (128 * S_x)[None, :] + 128 * 128 * K
    return O.reshape(NDIG, m, B)


@functools.lru_cache(maxsize=32)
def _small_consts(m: int, omega: int, p_name: str, device: str):
    """Bit-reversal index and per-stage (16, half) twiddles of _dft_small,
    on `device` once (a host copy per call would synchronise the stream)."""
    ctx = D.ctx_for(p_name)
    k = m.bit_length() - 1
    perm = [int(f"{i:0{k}b}"[::-1], 2) if k else 0 for i in range(m)]
    tws = [D.pack([pow(omega, (j * (m >> (s + 1))) % m, ctx.p)
                   for j in range(1 << s)], ctx, device=device)
           for s in range(k)]
    return torch.tensor(perm, device=device), tws


def _dft_small(a: torch.Tensor, omega: int, ctx) -> torch.Tensor:
    """Tiny-m DFT (m <= 8) as radix-2 butterflies along axis 1 (inputs
    canonical, as they come from the twiddle multiply)."""
    m, B = a.shape[1], a.shape[2]
    k = m.bit_length() - 1
    perm, stage_tws = _small_consts(m, omega % ctx.p, ctx.name,
                                    D.device_key(a.device))
    a = a[:, perm]
    for s in range(k):
        half = 1 << s
        blocks = m >> (s + 1)
        v = a.reshape(NLIMB, blocks, 2, half, B)
        top = v[:, :, 0]
        bot = v[:, :, 1]
        t = D.mont_mul(bot, stage_tws[s][:, None, :, None], ctx)
        a = torch.stack([D.add(top, t, ctx), D.sub(top, t, ctx)], dim=2) \
            .reshape(NLIMB, m, B)
    return a


def _dft_axis1(a: torch.Tensor, plan: NttPlan, level: int, ctx, max_m: int,
               res_omega, scale: torch.Tensor) -> torch.Tensor:
    """DFT over axis 1 (size m) of a (16, m, B) limb tensor; `scale` (a
    (16, 1) Montgomery scalar) is applied at the residual level, so the
    output is canonical."""
    m, B = a.shape[1], a.shape[2]
    if level == len(plan.twiddles):
        if res_omega is not None:
            return D.mont_mul(_dft_small(a, res_omega, ctx),
                              scale.reshape(NLIMB, 1, 1), ctx)
        return CF.planes_to_limbs_mul(
            _dft_planes(a, plan.res_mat, plan.res_rowsum), scale, ctx,
            mult_is_tile=False)
    m2 = max_m
    m1 = m // m2
    # t = t1 + m1*t2  ->  [t2, (t1, b)]; the DFT runs over t2
    a = a.reshape(NLIMB, m2, m1 * B)
    tw = plan.twiddles[level]                                  # (16, m2, m1)
    f = CF.planes_to_limbs_mul(_dft_planes(a, plan.base_mat, plan.base_rowsum),
                               tw, ctx, mult_is_tile=True, mult_major=B)
    f = f.reshape(NLIMB, m2, m1, B).transpose(1, 2).reshape(NLIMB, m1, m2 * B)
    g = _dft_axis1(f, plan, level + 1, ctx, max_m, res_omega, scale)
    return g.reshape(NLIMB, m1 * m2, B)                        # k = k1*m2 + k2


@functools.lru_cache(maxsize=64)
def _scalar_on(v: int, p_name: str, device: str) -> torch.Tensor:
    return D.pack_scalar(v, D.ctx_for(p_name), device=device)


def _scalar(v: int, ctx, device) -> torch.Tensor:
    """(16, 1) Montgomery limbs of v on `device`, packed and copied once per
    (value, device): a copy from host memory per call would synchronise the
    stream inside every NTT."""
    return _scalar_on(v % ctx.p, ctx.name, D.device_key(device))


def mxu_ntt(a: torch.Tensor, omega: int, k: int, max_m: Optional[int] = None,
            ctx=FR) -> torch.Tensor:
    """Forward NTT of a (16, n) Montgomery limb tensor: coeffs -> evals in
    natural order (the reference's contract)."""
    max_m = max_m or auto_max_m(1 << k)
    plan, res_omega = plan_on(1 << k, omega, a.device, ctx.name, max_m)
    one = _scalar(1, ctx, a.device)                            # Montgomery one
    n = a.shape[1]
    out = _dft_axis1(a.reshape(NLIMB, n, 1), plan, 0, ctx, max_m, res_omega,
                     one)
    return out.reshape(NLIMB, n)


def mxu_intt(a: torch.Tensor, omega_inv: int, k: int, divisor_inv: int,
             max_m: Optional[int] = None, ctx=FR) -> torch.Tensor:
    """Inverse NTT: evals -> coeffs scaled by divisor_inv (= 1/n).  The
    Montgomery multiply by the divisor both reduces mod p and scales."""
    max_m = max_m or auto_max_m(1 << k)
    plan, res_omega = plan_on(1 << k, omega_inv, a.device, ctx.name, max_m)
    n = a.shape[1]
    d = _scalar(divisor_inv, ctx, a.device)
    out = _dft_axis1(a.reshape(NLIMB, n, 1), plan, 0, ctx, max_m, res_omega, d)
    return out.reshape(NLIMB, n)


def mxu_ntt_batch_mapped(a: torch.Tensor, plan: NttPlan, res_omega, ctx=FR,
                         max_m: int = MAX_MATMUL, chunk: int = 64,
                         scale=None, out_dtype=None, pre_mult=None,
                         pad_to: int = 0) -> torch.Tensor:
    """Batched forward NTT over the LAST axis of a (16, C, n) limb tensor,
    `chunk` columns at a time (a Python loop over chunks takes the place of
    the reference's lax.map; zero columns are never padded in, so values
    are those of an unchunked transform).

    pre_mult: (16, n) limbs multiplied into every column first (ZETA coset
    scale); pad_to: zero-pad each column to this length before the NTT;
    scale: (16, 1) Montgomery scalar applied at the last level (default
    Montgomery one); out_dtype: torch.int16 stores canonical limbs in 16
    bits (int32 otherwise)."""
    C, n = a.shape[1], a.shape[2]
    n_out = pad_to if pad_to and pad_to > n else n
    out = torch.empty((NLIMB, C, n_out), dtype=out_dtype or LIMB,
                      device=a.device)
    if C == 0:
        return out
    if scale is None:
        scale = _scalar(1, ctx, a.device)                      # Montgomery one
    for lo in range(0, C, chunk):
        x = CF.as_limbs32(a[:, lo:lo + chunk])
        cb = x.shape[1]
        if pre_mult is not None:
            x = D.mont_mul(x, pre_mult[:, None, :], ctx)
        if n_out > n:
            x = torch.nn.functional.pad(x, (0, n_out - n))
        at = x.transpose(1, 2)                                 # (16, n_out, cb)
        f = _dft_axis1(at, plan, 0, ctx, max_m, res_omega, scale)
        out[:, lo:lo + cb] = f.transpose(1, 2).to(out.dtype)
    return out


def mxu_ntt_batch(a: torch.Tensor, plan: NttPlan, res_omega, ctx=FR,
                  max_m: int = MAX_MATMUL, chunk: int = 16,
                  scale=None) -> torch.Tensor:
    """The reference's mxu_ntt_batch (forward NTT over the LAST axis of a
    (16, C, n) limb tensor, `chunk` columns at a time, scaled by `scale` at
    the last level): mxu_ntt_batch_mapped, whose values the reference
    states are the same."""
    return mxu_ntt_batch_mapped(a, plan, res_omega, ctx, max_m, chunk, scale)


def mxu_lagrange_to_coeff_batch(a: torch.Tensor, omega_inv: int, k: int,
                                divisor_inv: int, ctx=FR) -> torch.Tensor:
    """(16, C, n) Lagrange -> coefficient batch (iNTT with the 1/n scale
    fused into the last level), as the reference's."""
    plan, res_omega = plan_on(1 << k, omega_inv, a.device, ctx.name)
    return mxu_ntt_batch_mapped(a, plan, res_omega, ctx,
                                scale=_scalar(divisor_inv, ctx, a.device))
