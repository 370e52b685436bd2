"""Radix-2 NTT of the port (counterpart of sha2cq_tpu/ops/ntt.py).

Device part: `ntt`, `intt` and `ntt_last_axis` over (16, ..., n) limb
tensors, the reference's butterfly transform stage for stage (one
bit-reversal gather, then k DIT stages, stage s pairing the two halves of
each (n / 2^{s+1}, 2, 2^s) block with the strided twiddle slice).  A CPU
tensor runs `ntt_last_axis_plain`, the same reshape/slice stages in int64
lanes; a CUDA tensor launches kernel K4 (ops/cuda_field.ntt_radix2).  The
prover's butterfly h route (plonk/device_eval.py, k < 12) runs on these
through the domain's device methods.

Host part: twiddle powers, the native-twiddle buffer and the host NTT/iNTT
that keygen, permutation, CQ and the domain's host methods call.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from ..fields import device as D
from ..fields.device import FR, NLIMB
from . import cuda_field as CF


@functools.lru_cache(maxsize=32)
def _bitrev_perm(k: int) -> np.ndarray:
    """(2^k,) int64 bit-reversal permutation (cached: callers must not
    write to it)."""
    idx = np.arange(1 << k, dtype=np.int64)
    perm = np.zeros_like(idx)
    for b in range(k):
        perm |= ((idx >> b) & 1) << (k - 1 - b)
    return perm


@functools.lru_cache(maxsize=64)
def _twiddle_table(omega: int, k: int, p_name: str, device: str) -> torch.Tensor:
    ctx = D.ctx_for(p_name)
    vals = powers_host(omega % ctx.p, max((1 << k) // 2, 1), ctx.p)
    return D.pack(vals, ctx, device=device)


def twiddle_table(omega: int, k: int, p_name: str = "Fr",
                  device="cpu") -> torch.Tensor:
    """(16, max(n/2, 1)) Montgomery limbs of omega^i, i < n/2, on `device`
    (built once per table and device)."""
    return _twiddle_table(omega, k, p_name, D.device_key(device))


def ntt_last_axis_plain(a: torch.Tensor, twiddles: torch.Tensor, k: int,
                        ctx=FR) -> torch.Tensor:
    """Plain version of K4: the reference's ntt_last_axis in int64 lanes
    (D.mont_mul_plain / D.add / D.sub).  a: (16, ..., 2^k) limbs (int32 or
    int16 storage); returns int32 limbs."""
    n = 1 << k
    perm = torch.from_numpy(_bitrev_perm(k)).to(a.device)
    a = CF.as_limbs32(a).index_select(a.dim() - 1, perm)
    if n == 1:
        return a
    lead = a.shape[:-1]
    for s in range(k):
        half = 1 << s
        blocks = n >> (s + 1)
        stride = 1 << (k - 1 - s)
        tw = twiddles[:, ::stride].reshape(
            (NLIMB,) + (1,) * (a.dim() - 2) + (1, half))
        v = a.reshape(*lead, blocks, 2, half)
        top = v[..., 0, :]
        bot = v[..., 1, :]
        t = D.mont_mul_plain(bot, tw, ctx)
        a = torch.stack([D.add(top, t, ctx), D.sub(top, t, ctx)], dim=-2) \
            .reshape(*lead, n)
    return a


def ntt_last_axis(a: torch.Tensor, twiddles: torch.Tensor, k: int,
                  ctx=FR) -> torch.Tensor:
    """Radix-2 NTT along the last axis of a (16, ..., n) limb tensor (the
    batched form of the whole-column-set basis conversions).  CPU tensors
    take ntt_last_axis_plain, CUDA tensors kernel K4."""
    if a.is_cuda:
        return CF.ntt_radix2(a, twiddles, k, ctx)
    return ntt_last_axis_plain(a, twiddles, k, ctx)


def ntt(a: torch.Tensor, omega: int, k: int) -> torch.Tensor:
    """Forward NTT of a (16, ..., n) Montgomery limb tensor along its last
    axis: coeffs -> evals at omega^0 .. omega^{n-1}, natural order."""
    return ntt_last_axis(a, twiddle_table(omega, k, "Fr", a.device), k)


def intt(a: torch.Tensor, omega_inv: int, k: int,
         divisor_inv: int) -> torch.Tensor:
    """Inverse NTT: evals -> coeffs, scaled by divisor_inv (= 1/n)."""
    out = ntt(a, omega_inv, k)
    d = D.pack_scalar(divisor_inv, FR, device=a.device)
    return D.mont_mul(out, d.reshape((NLIMB,) + (1,) * (out.dim() - 1)), FR)


def powers_host(base: int, n: int, p: int) -> list:
    """[1, base, base^2, ...] as ints (host; used for twiddle tables)."""
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % p
    return out


# ----------------------------- host reference -------------------------------

@functools.lru_cache(maxsize=64)
def _host_twiddle_buf(omega: int, n: int, p: int):
    """(n/2, 4) uint64 buffer of [w^0 .. w^{n/2-1}] for the native NTT."""
    from ..native_loader import fr_buf
    tws = [0] * (n // 2)
    cur = 1
    for i in range(n // 2):
        tws[i] = cur
        cur = cur * omega % p
    return fr_buf(tws)


def ntt_host(values: list, omega: int, p: int) -> list:
    """Host radix-2 NTT: native C kernel (fieldops.c fr_ntt, OpenMP) for
    large Fr transforms, recursive Python oracle otherwise."""
    n = len(values)
    from ..fields.host import FR_MOD
    if n >= 256 and p == FR_MOD and (n & (n - 1)) == 0:
        from ..native_loader import native_fr_ntt
        out = native_fr_ntt([v % p for v in values],
                            _host_twiddle_buf(omega % p, n, p),
                            n.bit_length() - 1)
        if out is not None:
            return out
    return _ntt_host_py(values, omega, p)


def _ntt_host_py(values: list, omega: int, p: int) -> list:
    """O(n^2)-free host radix-2 NTT (recursive), oracle for tests."""
    n = len(values)
    if n == 1:
        return list(values)
    even = _ntt_host_py(values[0::2], omega * omega % p, p)
    odd = _ntt_host_py(values[1::2], omega * omega % p, p)
    out = [0] * n
    w = 1
    for i in range(n // 2):
        t = w * odd[i] % p
        out[i] = (even[i] + t) % p
        out[i + n // 2] = (even[i] - t) % p
        w = w * omega % p
    return out


def intt_host(values: list, omega: int, p: int) -> list:
    n = len(values)
    ninv = pow(n, p - 2, p)
    out = ntt_host(values, pow(omega, p - 2, p), p)
    return [x * ninv % p for x in out]
