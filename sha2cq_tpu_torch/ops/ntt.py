"""NTT host helpers of the port (counterpart of sha2cq_tpu/ops/ntt.py).

Only the host side is ported here: twiddle powers, the native-twiddle
buffer and the host NTT/iNTT that keygen, permutation, CQ and the domain's
host methods call.  The device butterfly NTT (`ntt`, `intt`,
`ntt_last_axis`) is not ported yet (ROADMAP); the prover's device NTTs are
the digit-matmul route in ops/mxu_ntt.py.
"""
from __future__ import annotations

import functools


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
