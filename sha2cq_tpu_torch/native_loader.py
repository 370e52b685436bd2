"""Loader for the native (C) group kernels in native/fieldops.c.

Compiles the shared library on first use (cc, -O3) into the port's own
build directory, sha2cq_tpu_torch/_build/native/, and binds it via ctypes.
Concurrent processes build it once: the first takes an exclusive lock on a
file beside the library, compiles to a temporary name and moves the result
into place; the others wait on the lock and load the finished file.  Every
consumer falls back to the pure-Python Jacobian path when the toolchain or
binary is unavailable (`build_error` then says why), so the native layer is
an accelerator, never a requirement.

The port's own copy of sha2cq_tpu/native_loader.py, with its own build
directory and the locked, atomic build.
"""
from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import subprocess
import warnings
from typing import List, Optional

_HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_HERE, "native", "fieldops.c")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build",
                         "native")


def _lib_path() -> str:
    """Binary name keyed by a hash of the C source: a stale build (or a
    checked-in artifact from a clone, where git does not preserve mtimes)
    can never shadow a changed fieldops.c."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"libfieldops-{digest}.so")


_LIB = _lib_path()

_lib = None
_tried = False
build_error: Optional[str] = None   # why this process has no library


def build_locked(lib: str, cmd: List[str]) -> Optional[str]:
    """Make the library `lib` exist, running the compiler command `cmd` (its
    output path appended) unless another process already did.  Under an
    exclusive flock on a lock file beside it, a process that finds the
    library loads it as it is; otherwise it compiles to a temporary name in
    the same directory and moves the file into place with os.replace, so no
    process ever opens a half-written library.  None on success, else why
    the compiler is missing or failed."""
    build_dir = os.path.dirname(lib)
    os.makedirs(build_dir, exist_ok=True)
    with open(os.path.join(build_dir, "build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)     # released when the file closes
        if os.path.exists(lib):
            return None
        tmp = f"{lib}.{os.getpid()}.tmp"
        try:
            res = subprocess.run(cmd + ["-o", tmp], capture_output=True,
                                 text=True, timeout=120)
            if res.returncode != 0:
                return (f"{cmd[0]} failed ({res.returncode}): "
                        f"{res.stderr[-2000:]}")
            os.replace(tmp, lib)
        except (OSError, subprocess.TimeoutExpired) as e:
            return f"{cmd[0]} could not run: {e!r}"
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return None


def _build() -> bool:
    """Make _LIB exist (build_locked); False, with `build_error` set, when
    the compiler is missing or fails."""
    global build_error
    build_error = build_locked(_LIB, ["cc", "-O3", "-march=native",
                                      "-fopenmp", "-shared", "-fPIC", _SRC])
    return build_error is None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _tried, build_error
    if _lib is not None:
        return _lib
    if _tried:
        return None
    _tried = True
    if not os.path.exists(_LIB) and not _build():
        warnings.warn(f"native/fieldops.c did not build; the pure-Python "
                      f"path runs instead: {build_error}", RuntimeWarning)
        return None
    try:
        lib = ctypes.CDLL(_LIB)
        lib.g1_add_jac.argtypes = [ctypes.POINTER(ctypes.c_uint64)] * 3
        lib.g1_scalar_mul.argtypes = [ctypes.POINTER(ctypes.c_uint64)] * 3
        lib.g1_msm.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                               ctypes.POINTER(ctypes.c_uint64),
                               ctypes.c_long,
                               ctypes.POINTER(ctypes.c_uint64)]
        lib.g1_batch_scalar_mul.argtypes = lib.g1_msm.argtypes
        lib.g1_group_ntt.argtypes = [ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.POINTER(ctypes.c_uint64),
                                     ctypes.c_long, ctypes.c_int]
        lib.g2_batch_scalar_mul.argtypes = lib.g1_msm.argtypes
        lib.g2_msm.argtypes = lib.g1_msm.argtypes
        U64P = ctypes.POINTER(ctypes.c_uint64)
        lib.fr_ntt.argtypes = [U64P, U64P, ctypes.c_long, ctypes.c_int]
        lib.fr_fold.argtypes = [U64P, U64P, ctypes.c_long, U64P, ctypes.c_long]
        lib.fr_vec_scale.argtypes = [U64P, U64P, ctypes.c_long]
        lib.fr_vec_mul.argtypes = [U64P, U64P, ctypes.c_long]
        lib.fr_eval_poly.argtypes = [U64P, ctypes.c_long, U64P, U64P]
        lib.fr_kate_div.argtypes = [U64P, ctypes.c_long, U64P, U64P]
        lib.fr_batch_inv.argtypes = [U64P, ctypes.c_long]
        lib.bn_pairing_check.argtypes = [U64P, U64P, ctypes.c_long, U64P]
        lib.bn_pairing_check.restype = ctypes.c_int
        lib.fq_sqrt_batch.argtypes = [U64P, ctypes.c_long, U64P]
        lib.g1_jac_to_affine_batch.argtypes = [U64P, ctypes.c_long, U64P]
        lib.fr_ntt_multi.argtypes = [ctypes.POINTER(U64P), U64P,
                                     ctypes.c_long, ctypes.c_int,
                                     ctypes.c_long, U64P]
        lib.fr_perm_mul_acc.argtypes = [U64P] * 5 + [ctypes.c_long]
        lib.fr_perm_mul_acc_geo.argtypes = [U64P] * 6 + [ctypes.c_long]
        lib.fr_prefix_prod.argtypes = [U64P, U64P, U64P, ctypes.c_long]
        _lib = lib
        return lib
    except OSError as e:
        build_error = f"{_LIB} did not load: {e!r}"
        warnings.warn(build_error, RuntimeWarning)
        return None


# ----------------------------- marshalling ----------------------------------

def _u64s(x: int, n: int = 4) -> List[int]:
    return [(x >> (64 * i)) & ((1 << 64) - 1) for i in range(n)]


def _from_u64s(arr, off: int) -> int:
    v = 0
    for i in range(4):
        v |= int(arr[off + i]) << (64 * i)
    return v


def _pack_jac(points) -> "ctypes.Array":
    """points: list of host Jacobian tuples (X, Y, Z) ints."""
    raw = b"".join(x.to_bytes(32, "little") + y.to_bytes(32, "little")
                   + z.to_bytes(32, "little") for (x, y, z) in points)
    return (ctypes.c_uint64 * (12 * len(points))).from_buffer_copy(raw)


def _unpack_jac(buf, i: int = 0):
    return (_from_u64s(buf, 12 * i), _from_u64s(buf, 12 * i + 4),
            _from_u64s(buf, 12 * i + 8))


# g1_msm and g1_msm_indexed return nothing and leave `out` unwritten when
# their core fails to allocate; every point they do write has canonical
# coordinates (< q < 2^254), so an all-ones word marks an unwritten slot.
_UNWRITTEN = (1 << 64) - 1


def _msm_out() -> "ctypes.Array":
    return (ctypes.c_uint64 * 12)(*([_UNWRITTEN] * 12))


def _msm_result(out):
    """The Jacobian point in `out`; MemoryError if the C side left it
    unwritten (an allocation failed), rather than a silent identity."""
    if all(w == _UNWRITTEN for w in out):
        raise MemoryError("native G1 MSM could not allocate its buffers")
    return _unpack_jac(out)


def native_jac_mul(point_jac, scalar: int):
    """scalar * point (Jacobian in/out); returns None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pin = _pack_jac([point_jac])
    sc = (ctypes.c_uint64 * 4)(*_u64s(scalar))
    out = (ctypes.c_uint64 * 12)()
    lib.g1_scalar_mul(pin, sc, out)
    return _unpack_jac(out)


def native_msm(scalars: List[int], points_jac) -> Optional[tuple]:
    lib = get_lib()
    if lib is None:
        return None
    n = len(scalars)
    pin = _pack_jac(points_jac)
    out = _msm_out()
    lib.g1_msm(pin, _pack_scalars(scalars), ctypes.c_long(n), out)
    return _msm_result(out)


def pack_points_affine(points) -> Optional["ctypes.Array"]:
    """Pre-marshal a fixed MSM basis (affine G1 tuples) once; reuse with
    native_msm_packed.  Re-packing the Lagrange basis dominated repeated
    commit_lagrange calls (124 advice columns per SHA-256 proof)."""
    if get_lib() is None:
        return None
    if any(pt is None for pt in points):
        return None  # identity points: fall back to the generic path
    return _pack_jac([(x, y, 1) for (x, y) in points])


def native_msm_packed(scalars: List[int], packed, n: int) -> Optional[tuple]:
    """MSM over the first n points of a pack_points_affine buffer."""
    lib = get_lib()
    if lib is None:
        return None
    out = _msm_out()
    lib.g1_msm(packed, _pack_scalars(scalars), ctypes.c_long(n), out)
    return _msm_result(out)


def native_msm_indexed(scalars: List[int], indices: List[int],
                       packed) -> Optional[tuple]:
    """out = sum_i scalars[i] * basis[indices[i]] over a pack_points_affine
    buffer (the CQ sparse a/qa/a0/m commitments)."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(scalars)
    idx = (ctypes.c_long * n)(*indices)
    out = _msm_out()
    lib.g1_msm_indexed(packed, idx, _pack_scalars(scalars),
                       ctypes.c_long(n), out)
    return _msm_result(out)


def native_msm_multi(jobs) -> Optional[List[tuple]]:
    """K independent MSMs in ONE native call (g1_msm_unified, mode 0:
    OpenMP across jobs).  jobs: list of (packed_basis, indices_or_None,
    scalars) — packed_basis from pack_points_affine, scalars a list (reduced
    mod r here, once) or a canonical (n, 4) u64 buffer, indices a list or
    an int64 array.  Returns a list of Jacobian tuples, or None when native
    is unavailable or any job's basis isn't packed; raises MemoryError when
    the C side could not allocate a job (its slot would read as the
    identity)."""
    res = native_msm_unified([("p", packed, indices, scalars)
                              for packed, indices, scalars in jobs])
    return raise_on_failed_jobs(res, "native_msm_multi")


def native_msm_grouped_multi(jobs) -> Optional[List[tuple]]:
    """K grouped sparse MSMs in ONE native call (g1_msm_unified, mode 1:
    OpenMP across jobs).  jobs: list of (packed_basis, rows, starts,
    scalars) — rows/starts contiguous int64 arrays (CSR: rows sorted by
    group, starts of length ngroups+1), scalars a (ngroups, 4) u64 limb
    buffer.  Returns Jacobian tuples, or None when native is unavailable;
    raises MemoryError when the C side could not allocate a job."""
    res = native_msm_unified([("g", packed, rows, starts, scalars)
                              for packed, rows, starts, scalars in jobs])
    return raise_on_failed_jobs(res, "native_msm_grouped_multi")


def raise_on_failed_jobs(res, name: str):
    if res is not None and any(r is None for r in res):
        failed = [j for j, r in enumerate(res) if r is None]
        raise MemoryError(f"{name}: the native MSM could not allocate "
                          f"job(s) {failed}")
    return res


def native_msm_unified(jobs) -> Optional[List[Optional[tuple]]]:
    """Plain/indexed AND grouped MSM jobs co-scheduled in ONE native call
    (g1_msm_unified — one OpenMP region, so grouped b0/p jobs fill the
    tail-idle cores of the indexed batch instead of running after it).
    jobs: list of ("p", packed, indices_or_None, scalars) or
    ("g", packed, rows, starts, scalars).  Returns one Jacobian tuple per
    job (None for a job the native side failed to allocate: its status is
    nonzero), or None when native is unavailable entirely."""
    lib = get_lib()
    if lib is None or any(j[1] is None for j in jobs):
        return None
    if not hasattr(lib, "g1_msm_unified"):
        return None
    k = len(jobs)
    if k == 0:
        return []
    import numpy as np
    U64P = ctypes.POINTER(ctypes.c_uint64)
    LP = ctypes.POINTER(ctypes.c_long)
    modes = (ctypes.c_long * k)()
    bases = (U64P * k)()
    idx_or_rows = (LP * k)()
    starts = (LP * k)()
    sizes = (ctypes.c_long * k)()
    scal = (U64P * k)()
    keep = []
    for j, job in enumerate(jobs):
        if job[0] == "g":
            _, packed, rw, st, sc = job
            modes[j] = 1
            ra = np.ascontiguousarray(rw, dtype=np.int64)
            sa = np.ascontiguousarray(st, dtype=np.int64)
            sb = np.ascontiguousarray(sc)
            keep.extend((ra, sa, sb))
            idx_or_rows[j] = ctypes.cast(ra.ctypes.data_as(LP), LP)
            starts[j] = ctypes.cast(sa.ctypes.data_as(LP), LP)
            sizes[j] = sa.shape[0] - 1
            scal[j] = _u64p(sb)
        else:
            _, packed, indices, scalars = job
            modes[j] = 0
            starts[j] = None
            if indices is None:
                idx_or_rows[j] = None
            else:
                ia = np.ascontiguousarray(indices, dtype=np.int64)
                keep.append(ia)
                idx_or_rows[j] = ctypes.cast(ia.ctypes.data_as(LP), LP)
            if isinstance(scalars, np.ndarray):
                sb = np.ascontiguousarray(scalars)
                keep.append(sb)
                scal[j] = _u64p(sb)
                sizes[j] = sb.shape[0]
            else:
                sb = _pack_scalars([s % _FR_MOD for s in scalars])
                keep.append(sb)
                scal[j] = ctypes.cast(sb, U64P)
                sizes[j] = len(scalars)
        bases[j] = ctypes.cast(job[1], U64P)
    out = (ctypes.c_uint64 * (12 * k))()
    status = (ctypes.c_long * k)()
    lib.g1_msm_unified.restype = ctypes.c_long
    lib.g1_msm_unified(modes, bases, idx_or_rows, starts, sizes, scal,
                       ctypes.c_long(k), out, status)
    return [None if status[j] else _unpack_jac(out, j) for j in range(k)]


def native_fr_ntt_multi(bufs, twiddles_buf, k: int, ninv: Optional[int] = None) -> bool:
    """In-place NTT of every (n, 4) u64 buffer in bufs (one native call,
    OpenMP across transforms).  Pass inverse twiddles + ninv = 1/n for a
    batched iNTT.  Returns False when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    count = len(bufs)
    if count == 0:
        return True
    import numpy as np
    U64P = ctypes.POINTER(ctypes.c_uint64)
    ptrs = (U64P * count)()
    for j, buf in enumerate(bufs):
        assert buf.flags["C_CONTIGUOUS"]
        ptrs[j] = _u64p(buf)
    n = bufs[0].shape[0]
    ninv_buf = None if ninv is None else fr_buf([ninv])
    lib.fr_ntt_multi(ptrs, _u64p(np.ascontiguousarray(twiddles_buf)),
                     ctypes.c_long(n), ctypes.c_int(k),
                     ctypes.c_long(count),
                     None if ninv_buf is None else _u64p(ninv_buf))
    return True


def native_batch_scalar_mul(points_jac, scalars: List[int]):
    lib = get_lib()
    if lib is None:
        return None
    n = len(scalars)
    pin = _pack_jac(points_jac)
    out = (ctypes.c_uint64 * (12 * n))()
    lib.g1_batch_scalar_mul(pin, _pack_scalars(scalars), ctypes.c_long(n), out)
    raw = bytes(out)
    return [tuple(int.from_bytes(raw[96 * i + 32 * c: 96 * i + 32 * c + 32],
                                 "little") for c in range(3))
            for i in range(n)]


# ------------------- numpy-fast marshalling (bulk group NTT) -----------------

def _np_u64_limbs(ints, nlimb: int):
    """list of python ints -> (n, nlimb) uint64 array.

    int.to_bytes runs at C speed (~100 ns), so serializing through a byte
    buffer is ~100x faster than object-array shifts + int() per limb — the
    object-array version was minutes per 2^20-point group-NTT call."""
    import numpy as np
    nbytes = 8 * nlimb
    buf = b"".join(int(x).to_bytes(nbytes, "little") for x in ints)
    return np.frombuffer(buf, dtype="<u8").reshape(len(ints), nlimb).copy()


def _np_from_u64_limbs(arr):
    """(n, nlimb) uint64 -> list of python ints (via one bytes round trip)."""
    n, nlimb = arr.shape
    nbytes = 8 * nlimb
    raw = arr.astype("<u8").tobytes()
    return [int.from_bytes(raw[i * nbytes:(i + 1) * nbytes], "little")
            for i in range(n)]


def _g2_jac_to_affine(coords: List[int]):
    """u64-decoded (x0,x1,y0,y1,z0,z1) canonical Jacobian -> G2 affine."""
    from .fields.host import FQ_MOD, inv_mod
    x0, x1, y0, y1, z0, z1 = coords
    if z0 == 0 and z1 == 0:
        return None
    p = FQ_MOD
    norm = (z0 * z0 + z1 * z1) % p
    ninv = inv_mod(norm, p)
    iz = (z0 * ninv % p, (-z1) * ninv % p)          # 1/z in Fq2

    def m(a, b):
        return ((a[0] * b[0] - a[1] * b[1]) % p, (a[0] * b[1] + a[1] * b[0]) % p)

    iz2 = m(iz, iz)
    iz3 = m(iz2, iz)
    ax = m((x0, x1), iz2)
    ay = m((y0, y1), iz3)
    return (ax, ay)


_Z1 = (1).to_bytes(32, "little") + (0).to_bytes(32, "little")
_ZERO_G2 = bytes(192)


def _pack_g2_affine(points) -> "ctypes.Array":
    raw = b"".join(
        _ZERO_G2 if pt is None else (
            pt[0][0].to_bytes(32, "little") + pt[0][1].to_bytes(32, "little")
            + pt[1][0].to_bytes(32, "little") + pt[1][1].to_bytes(32, "little")
            + _Z1)
        for pt in points)
    return (ctypes.c_uint64 * (24 * len(points))).from_buffer_copy(raw)


_g2_srs_pack_cache: dict = {}


def _pack_g2_affine_cached(points):
    """Packed-buffer cache for long-lived G2 SRS lists (the per-table commit
    repacked the whole 2^19-point SRS every call)."""
    key = id(points)
    hit = _g2_srs_pack_cache.get(key)
    if hit is not None and hit[0] is points and len(points) == hit[2]:
        return hit[1]
    buf = _pack_g2_affine(points)
    if len(points) > 4096:
        _g2_srs_pack_cache[key] = (points, buf, len(points))
    return buf


# BN254 scalar-field modulus (native_loader stays import-cycle-free of the
# package, so the constant lives here too; pinned equal in tests)
_FR_MOD = 0x30644E72E131A029B85045B68181585D2833E84879B9709143E1F593F0000001


def _pack_scalars(scalars: List[int]) -> "ctypes.Array":
    raw = b"".join(int(x).to_bytes(32, "little") for x in scalars)
    return (ctypes.c_uint64 * (4 * len(scalars))).from_buffer_copy(raw)


def native_g2_batch_scalar_mul(points_affine, scalars: List[int]):
    """out[i] = scalar[i] * point[i] over G2; None when native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(scalars)
    pin = _pack_g2_affine(points_affine)
    out = (ctypes.c_uint64 * (24 * n))()
    lib.g2_batch_scalar_mul(pin, _pack_scalars(scalars), ctypes.c_long(n), out)
    return [_g2_jac_to_affine([_from_u64s(out, 24 * i + 4 * c) for c in range(6)])
            for i in range(n)]


def native_g2_msm(scalars: List[int], points_affine):
    """Pippenger MSM over G2; None when native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(scalars)
    pin = _pack_g2_affine_cached(points_affine)
    out = (ctypes.c_uint64 * 24)()
    lib.g2_msm(pin, _pack_scalars(scalars), ctypes.c_long(n), out)
    return _g2_jac_to_affine([_from_u64s(out, 4 * c) for c in range(6)])


def np_jac_from_tuples(points_jac):
    """list of (X, Y, Z) int tuples -> (n, 12) uint64 canonical buffer."""
    flat = [c for p in points_jac for c in p]
    return _np_u64_limbs(flat, 4).reshape(len(points_jac), 12)


def np_jac_to_tuples(buf):
    """(n, 12) uint64 -> list of (X, Y, Z) int tuples."""
    n = buf.shape[0]
    coords = _np_from_u64_limbs(buf.reshape(3 * n, 4))
    return [tuple(coords[3 * i:3 * i + 3]) for i in range(n)]


def native_group_ntt_np(buf, twiddles_np, k: int) -> bool:
    """In-place group NTT on a (n, 12) uint64 canonical-Jacobian buffer.
    Returns False when the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "g1_group_ntt"):
        return False
    import numpy as np
    assert buf.flags["C_CONTIGUOUS"]
    lib.g1_group_ntt(buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
                     np.ascontiguousarray(twiddles_np).ctypes.data_as(
                         ctypes.POINTER(ctypes.c_uint64)),
                     ctypes.c_long(buf.shape[0]), ctypes.c_int(k))
    return True


def native_batch_scalar_mul_np(buf, scalars_np):
    """(n,12) uint64 points x (n,4) uint64 scalars -> (n,12) uint64, or None."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np
    out = np.empty_like(buf)
    lib.g1_batch_scalar_mul(
        np.ascontiguousarray(buf).ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        np.ascontiguousarray(scalars_np).ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
        ctypes.c_long(buf.shape[0]),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)))
    return out


def native_group_ntt(points_jac, twiddles: List[int], k: int):
    """In-place-semantics radix-2 NTT over G1 Jacobian points (canonical
    coords).  points_jac: list of (X, Y, Z) int tuples, len n = 2^k;
    twiddles: [w^0 .. w^{n/2-1}].  Returns transformed list, or None when
    the native library is unavailable."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "g1_group_ntt"):
        return None
    import numpy as np
    n = len(points_jac)
    assert n == 1 << k
    buf = np.ascontiguousarray(np_jac_from_tuples(points_jac))
    tw = _np_u64_limbs(twiddles, 4)
    native_group_ntt_np(buf, tw, k)
    return np_jac_to_tuples(buf)


# ------------------------- Fr scalar-field kernels ---------------------------
#
# Bulk host-side Fr work (NTTs, poly folds, Horner, kate division, batch
# inversion) — the prover's CQ log-derivative and multiopen phases.  Values
# cross the ABI as (n, 4) little-endian u64 numpy buffers (canonical form);
# the helpers below also accept/return python int lists.

def _u64p(arr):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def fr_buf(ints) -> "object":
    """list of ints -> contiguous (n, 4) uint64 buffer."""
    return _np_u64_limbs(ints, 4)


def fr_unbuf(arr) -> List[int]:
    return _np_from_u64_limbs(arr)


def native_fr_ntt(values: List[int], twiddles_buf, k: int) -> Optional[List[int]]:
    """Radix-2 NTT over Fr (ntt_host semantics).  twiddles_buf: (n/2, 4)
    uint64 buffer of [w^0 .. w^{n/2-1}] (cache it across calls)."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np
    buf = fr_buf(values)
    lib.fr_ntt(_u64p(buf), _u64p(np.ascontiguousarray(twiddles_buf)),
               ctypes.c_long(len(values)), ctypes.c_int(k))
    return fr_unbuf(buf)


def native_fr_ntt_buf(buf, twiddles_buf, k: int) -> bool:
    """In-place NTT on an existing (n, 4) uint64 buffer."""
    lib = get_lib()
    if lib is None:
        return False
    import numpy as np
    lib.fr_ntt(_u64p(buf), _u64p(np.ascontiguousarray(twiddles_buf)),
               ctypes.c_long(buf.shape[0]), ctypes.c_int(k))
    return True


def native_fr_fold_buf(acc_buf, add_buf, v: int) -> bool:
    """acc = acc * v + add (elementwise over (n,4) buffers; add may be None
    or shorter than acc)."""
    lib = get_lib()
    if lib is None:
        return False
    vb = fr_buf([v])
    addn = 0 if add_buf is None else add_buf.shape[0]
    addp = None if add_buf is None else _u64p(add_buf)
    lib.fr_fold(_u64p(acc_buf), addp, ctypes.c_long(addn), _u64p(vb),
                ctypes.c_long(acc_buf.shape[0]))
    return True


def native_fr_vec_mul_buf(buf, other) -> bool:
    """buf[i] *= other[i] elementwise over (n,4) canonical limb buffers."""
    lib = get_lib()
    if lib is None:
        return False
    lib.fr_vec_mul(_u64p(buf), _u64p(other), ctypes.c_long(buf.shape[0]))
    return True


def native_fr_scale_buf(buf, c: int) -> bool:
    """buf[i] *= c over a (n,4) canonical limb buffer."""
    lib = get_lib()
    if lib is None:
        return False
    lib.fr_vec_scale(_u64p(buf), _u64p(fr_buf([c])),
                     ctypes.c_long(buf.shape[0]))
    return True


def native_fr_eval_buf(buf, x: int) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    xb = fr_buf([x])
    out = (ctypes.c_uint64 * 4)()
    lib.fr_eval_poly(_u64p(buf), ctypes.c_long(buf.shape[0]), _u64p(xb), out)
    return _from_u64s(out, 0)


def native_fr_eval(coeffs: List[int], x: int) -> Optional[int]:
    lib = get_lib()
    if lib is None:
        return None
    return native_fr_eval_buf(fr_buf(coeffs), x)


def native_fr_kate_buf(buf, b: int):
    """(n,4) coeff buffer -> (n-1,4) quotient buffer of (p(X)-p(b))/(X-b)."""
    lib = get_lib()
    if lib is None:
        return None
    import numpy as np
    n = buf.shape[0]
    out = np.empty((n - 1, 4), dtype="<u8")
    bb = fr_buf([b])
    lib.fr_kate_div(_u64p(buf), ctypes.c_long(n), _u64p(bb), _u64p(out))
    return out


def native_fr_batch_inv_buf(buf) -> bool:
    """In-place Montgomery batch inversion of a (n, 4) u64 buffer (zeros
    stay zero).  Returns False when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    lib.fr_batch_inv(_u64p(buf), ctypes.c_long(buf.shape[0]))
    return True


def native_fr_batch_inv(values: List[int]) -> Optional[List[int]]:
    lib = get_lib()
    if lib is None:
        return None
    buf = fr_buf(values)
    lib.fr_batch_inv(_u64p(buf), ctypes.c_long(len(values)))
    return fr_unbuf(buf)


def native_pairing_check(pairs, want_fq12: bool = False):
    """prod e(Pi, Qi) == 1 via the C multi-Miller loop + final exponentiation
    (native/fieldops.c bn_pairing_check).  pairs: [(G1Affine, G2Affine)];
    identity-point pairs contribute e = 1 and are filtered here.  Returns
    None when native is unavailable; with want_fq12=True returns
    (ok, fq12_tuple) for oracle comparison in tests."""
    lib = get_lib()
    if lib is None:
        return None
    live = [(p, q) for p, q in pairs if p is not None and q is not None]
    n = len(live)
    g1 = (ctypes.c_uint64 * (8 * n))()
    g2 = (ctypes.c_uint64 * (16 * n))()
    for i, (p, q) in enumerate(live):
        g1[8 * i: 8 * i + 4] = _u64s(p[0])
        g1[8 * i + 4: 8 * i + 8] = _u64s(p[1])
        g2[16 * i: 16 * i + 4] = _u64s(q[0][0])
        g2[16 * i + 4: 16 * i + 8] = _u64s(q[0][1])
        g2[16 * i + 8: 16 * i + 12] = _u64s(q[1][0])
        g2[16 * i + 12: 16 * i + 16] = _u64s(q[1][1])
    out = (ctypes.c_uint64 * 48)()
    ok = bool(lib.bn_pairing_check(g1, g2, ctypes.c_long(n), out))
    if not want_fq12:
        return ok
    coeffs = [_from_u64s(out, 4 * i) for i in range(12)]
    f = ((tuple(coeffs[0:2]), tuple(coeffs[2:4]), tuple(coeffs[4:6])),
         (tuple(coeffs[6:8]), tuple(coeffs[8:10]), tuple(coeffs[10:12])))
    return ok, f


def native_fq_sqrt(x: int):
    """Candidate sqrt of x mod q via x^((q+1)/4) (q = 3 mod 4); caller must
    check cand^2 == x (non-residues yield a wrong value, not an error).
    None when native is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    xs = (ctypes.c_uint64 * 4)(*_u64s(x))
    ys = (ctypes.c_uint64 * 4)()
    lib.fq_sqrt_batch(xs, ctypes.c_long(1), ys)
    return _from_u64s(ys, 0)


def native_jac_to_affine(point_jac):
    """Single Jacobian -> affine (native inversion); None if unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    pin = _pack_jac([point_jac])
    out = (ctypes.c_uint64 * 8)()
    lib.g1_jac_to_affine_batch(pin, ctypes.c_long(1), out)
    x, y = _from_u64s(out, 0), _from_u64s(out, 4)
    if x == 0 and y == 0:
        return (None,)  # wrapped identity so callers can distinguish from miss
    return (x, y)
