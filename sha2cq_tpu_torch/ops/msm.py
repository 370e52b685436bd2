"""Multi-scalar multiplication dispatch of the port (counterpart of
sha2cq_tpu/ops/msm.py, host side only).

Commitments run on the native host Pippenger (native/fieldops.c) below
HOST_THRESHOLD, exactly as in the reference.  The device MSM is not ported
yet, so msm() above the threshold raises (ROADMAP, "device MSM").
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from ..curves import host as CH
from ..fields import host as H

# Same threshold as the reference: below it the host Pippenger is used.
HOST_THRESHOLD = 1 << 20


def msm_host(scalars: Sequence[int], points, packed=None) -> CH.G1Affine:
    """Host Pippenger (c=8): native C kernel when available, else the
    pure-Python Jacobian accumulation.

    packed: optional pre-marshalled basis buffer (native_loader
    .pack_points_affine) covering at least len(scalars) points — skips the
    per-call point marshalling for fixed commitment bases."""
    n = len(scalars)
    if n == 0:
        return None
    if packed is not None:
        from ..native_loader import native_msm_packed
        res = native_msm_packed([s % H.FR_MOD for s in scalars], packed, n)
        if res is not None:
            return CH.jac_to_affine(res)
    from ..native_loader import native_msm
    jac = [CH.jac_from_affine(pt) for pt in points[:n]]
    res = native_msm([s % H.FR_MOD for s in scalars], jac)
    if res is not None:
        return CH.jac_to_affine(res)
    c = 8 if n >= 32 else 4
    nw = (256 + c - 1) // c
    total = CH.JAC_IDENTITY
    for w in range(nw - 1, -1, -1):
        if total != CH.JAC_IDENTITY:
            for _ in range(c):
                total = CH.jac_double(total)
        buckets: dict = {}
        for s, pt in zip(scalars, points):
            if pt is None:
                continue
            d = ((s % H.FR_MOD) >> (c * w)) & ((1 << c) - 1)
            if d:
                if d in buckets:
                    buckets[d] = CH.jac_add_affine(buckets[d], pt)
                else:
                    buckets[d] = CH.jac_from_affine(pt)
        run = CH.JAC_IDENTITY
        acc = CH.JAC_IDENTITY
        for d in range(max(buckets) if buckets else 0, 0, -1):
            if d in buckets:
                run = CH.jac_add(run, buckets[d])
            acc = CH.jac_add(acc, run)
        total = CH.jac_add(total, acc)
    return CH.jac_to_affine(total)


def msm(scalars: Sequence[int], points, packed=None) -> CH.G1Affine:
    """Dispatch: MSMs below HOST_THRESHOLD run on the native host layer; the
    device MSM is not ported yet (ROADMAP, "device MSM")."""
    if len(scalars) < HOST_THRESHOLD:
        return msm_host(scalars, points, packed=packed)
    raise NotImplementedError(
        f"MSM of {len(scalars)} points needs the device MSM, which the "
        "PyTorch port does not have yet (ROADMAP: device MSM)")


def packed_basis(obj, attr: str, points):
    """Lazily cache a pre-marshalled native basis buffer on `obj` (None when
    the native lib is unavailable).

    Big bases (>= 2^14 points) are also disk-cached as raw limb bytes:
    marshalling a 2^18-point Lagrange basis costs seconds of Python bigint
    `to_bytes` per fresh process (most of the cold-process cq_msms tax),
    while reading the 24 MB blob back is ~30 ms."""
    if attr not in obj.__dict__:
        from ..native_loader import pack_points_affine
        pts = points() if callable(points) else points
        packed = None
        if len(pts) >= DISK_BASIS_MIN and not any(p is None for p in pts):
            packed = _packed_basis_disk(pts)
        if packed is None:
            packed = pack_points_affine(pts)
        obj.__dict__[attr] = packed
    return obj.__dict__[attr]


DISK_BASIS_MIN = 1 << 14  # smallest basis worth a disk round trip


def _packed_basis_disk(points):
    """Disk-backed pack_points_affine: raw bytes keyed on (len, 16 sample
    points), written atomically.  Returns None without the native library."""
    import ctypes
    import hashlib
    import os

    from ..native_loader import get_lib, pack_points_affine
    if get_lib() is None:
        return None
    n = len(points)
    sample = [points[(i * (n - 1)) // 15] for i in range(16)]
    key = hashlib.sha256(repr((n, sample)).encode()).hexdigest()[:20]
    cache_dir = os.path.expanduser(
        os.environ.get("SHA2CQ_CACHE", "~/.cache/sha2cq_jax"))
    path = os.path.join(cache_dir, f"packedbasis_{key}.bin")
    try:
        with open(path, "rb") as f:
            raw = f.read()
        if len(raw) == 96 * n:
            return (ctypes.c_uint64 * (12 * n)).from_buffer_copy(raw)
    except OSError:
        pass                     # no cache entry yet: pack and write one
    packed = pack_points_affine(points)
    if packed is not None:
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            os.makedirs(cache_dir, exist_ok=True)
            with open(tmp, "wb") as f:
                f.write(bytes(packed))
            os.replace(tmp, path)
        except OSError:
            pass                 # a read-only cache costs speed, not results
    return packed


def msm_multi(jobs) -> list:
    """Many independent MSMs in ONE native call (g1_msm_multi, OpenMP across
    jobs) — the prover's per-phase commitment batches.  jobs: list of
    (packed_basis, indices_or_None, scalars, fallback_points); falls back to
    the per-job host path when native is unavailable.  Returns G1Affine (or
    None for empty jobs) per job."""
    out: list = [None] * len(jobs)
    native = [(j, job) for j, job in enumerate(jobs)
              if len(job[2]) > 0 and job[0] is not None]
    rest = [(j, job) for j, job in enumerate(jobs)
            if len(job[2]) > 0 and job[0] is None]
    if native:
        from ..native_loader import native_msm_multi
        reduced = [(packed, indices,
                    scalars if isinstance(scalars, np.ndarray)
                    else [s % H.FR_MOD for s in scalars])
                   for _, (packed, indices, scalars, _pts) in native]
        res = native_msm_multi(reduced)
        if res is not None:
            for (j, _), jac in zip(native, res):
                out[j] = CH.jac_to_affine(jac)
        else:
            rest = native + rest
    for j, (packed, indices, scalars, pts) in rest:
        if isinstance(scalars, np.ndarray):
            from ..native_loader import fr_unbuf
            scalars = fr_unbuf(scalars)
        if indices is None:
            out[j] = msm_host(list(scalars), pts, packed=packed)
        else:
            out[j] = msm_indexed(scalars, indices, pts, packed=packed)
    return out


def msm_combined(jobs, gjobs) -> list:
    """Plain/indexed jobs + grouped jobs in ONE native OpenMP region
    (g1_msm_unified), so the grouped b0/p batch fills the tail-idle cores
    of the indexed batch instead of running strictly after it.  Returns
    results in jobs + gjobs order; per-job allocation failures (and an
    absent/old native lib) fall back to the split paths."""
    uni = [("p", p, i, s) for (p, i, s, _pts) in jobs] + \
          [("g", p, r, st, sc) for (p, r, st, sc) in gjobs]
    from ..native_loader import native_msm_unified
    res = native_msm_unified(uni)
    if res is not None and all(r is not None for r in res):
        return [CH.jac_to_affine(jac) for jac in res]
    out_p = msm_multi(jobs)
    out_g = msm_grouped_multi(gjobs) if gjobs else []
    return out_p + out_g


def msm_grouped_multi(jobs) -> list:
    """Many grouped sparse MSMs in ONE native call: per job
    (packed_basis, rows, starts, scalars) computes
    sum_g scalars[g] * (sum_{i in rows[starts[g]:starts[g+1]]} basis[rows[i]]).
    Native-only — callers gate on get_lib(); group sums are one mixed add
    per row, then Pippenger over the (much smaller) per-group sums."""
    from ..native_loader import native_msm_grouped_multi
    res = native_msm_grouped_multi(jobs)
    if res is None:
        raise RuntimeError("msm_grouped_multi requires the native library")
    return [CH.jac_to_affine(jac) for jac in res]


def msm_indexed(scalars: Sequence[int], indices: Sequence[int], points,
                packed=None) -> CH.G1Affine:
    """sum_i scalars[i] * points[indices[i]]; native indexed kernel over a
    packed basis when available, else gather + host path."""
    if packed is not None:
        from ..native_loader import native_msm_indexed
        res = native_msm_indexed([s % H.FR_MOD for s in scalars],
                                 list(indices), packed)
        if res is not None:
            return CH.jac_to_affine(res)
    return msm_host(list(scalars), [points[i] for i in indices])
