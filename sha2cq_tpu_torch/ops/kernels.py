"""Build and load the port's hand-written CUDA kernels (csrc/*.cu).

Route: nvcc compiles every source in csrc/ for sm_90a, one nvcc process per
source, all started together, and links the objects into one shared library
with a plain C interface, loaded with ctypes (no PyTorch headers, so a build
takes seconds).  The library is built at first use into a directory that
.gitignore lists, keyed by a hash of the sources and flags, and written
atomically (temp file + os.replace), so a changed source never loads a stale
binary and concurrent processes never see a half-written one.

Conventions of every C entry point: pointers and the CUDA stream arrive as
`c_void_p`, sizes as `c_long`; the function launches on the given stream,
does not synchronise, allocates nothing, and returns `cudaGetLastError()`.
`check()` turns a nonzero return into a RuntimeError.

Nothing here runs at import: importing the module needs no CUDA toolkit, and
nvcc is only called when a CUDA tensor first needs a kernel.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

CSRC_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                         "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-lineinfo"] + ARCH_FLAGS
LINK_FLAGS = ["-shared"] + ARCH_FLAGS

_lock = threading.Lock()
_lib = None
build_info: dict = {}   # {"seconds": float, "path": str, "log": str} of this process's build

vp = ctypes.c_void_p
cl = ctypes.c_long
ci = ctypes.c_int


def _sources():
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def lib_path() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for f in sorted(glob.glob(os.path.join(CSRC_DIR, "*"))):
        with open(f, "rb") as fh:
            h.update(os.path.basename(f).encode())
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"libsha2cq_kernels-{h.hexdigest()[:16]}.so")


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                           "CUDA kernels cannot be built")
    return path


def build(verbose: bool = False) -> str:
    """Compile csrc/*.cu into the hashed library if it is not built yet.
    verbose=True adds `-Xptxas -v` and keeps the compiler's report in
    build_info["log"] (registers, shared memory and spills per kernel)."""
    out = lib_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    objdir = f"{tmp}.objs"
    os.makedirs(objdir, exist_ok=True)
    compiler = nvcc()
    t0 = time.perf_counter()
    jobs = []
    try:
        for src in _sources():
            obj = os.path.join(objdir, os.path.basename(src) + ".o")
            cmd = [compiler] + NVCC_FLAGS + \
                (["-Xptxas", "-v"] if verbose else []) + \
                ["-I", CSRC_DIR, "-c", "-o", obj, src]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
        logs, failed = [], []
        for src, _obj, proc in jobs:      # wait for every compile
            _out, err = proc.communicate()
            logs.append(err)
            if proc.returncode != 0:
                failed.append(f"{os.path.basename(src)} ({proc.returncode}):"
                              f"\n{err[-8000:]}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        res = subprocess.run([compiler] + LINK_FLAGS + ["-o", tmp] +
                             [obj for _src, obj, _p in jobs],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr[-8000:]}")
        os.replace(tmp, out)
    finally:
        for _src, _obj, proc in jobs:     # none outlives a failed build
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(objdir, ignore_errors=True)
    build_info.update(seconds=time.perf_counter() - t0, path=out,
                      log="".join(logs))
    return out


def _bind(lib):
    lib.k_error_string.argtypes = [ci]
    lib.k_error_string.restype = ctypes.c_char_p
    lib.k1_mont_mul.argtypes = [vp, vp, vp, cl, cl, cl, vp, ctypes.c_uint32, vp]
    lib.k1_mont_mul.restype = ci
    lib.k2_planes_to_limbs_mul.argtypes = [vp, vp, vp, cl, cl, cl, cl, cl, cl,
                                           vp, ctypes.c_uint32, vp, vp]
    lib.k2_planes_to_limbs_mul.restype = ci
    lib.k3_h_vm_run.argtypes = [vp, ci, vp, ci, vp, vp, vp, vp, cl, ci, ci,
                                vp, ctypes.c_uint32, vp]
    lib.k3_h_vm_run.restype = ci
    lib.k4_ntt_radix2.argtypes = [vp, ci, vp, vp, cl, ci, vp,
                                  ctypes.c_uint32, vp]
    lib.k4_ntt_radix2.restype = ci
    return lib


def get_lib():
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(ctypes.CDLL(build()))
        return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        msg = get_lib().k_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")


def stream_ptr(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def u32_array(words):
    """Host array of uint32 words (passed by pointer; the C side copies it
    into a by-value kernel argument before the launch)."""
    return (ctypes.c_uint32 * len(words))(*words)


def field_words(ctx):
    """(p as 8 little-endian uint32 words, -p^{-1} mod 2^32) of a field."""
    p = ctx.p
    words = [(p >> (32 * i)) & 0xFFFFFFFF for i in range(8)]
    n0 = (-pow(p, -1, 1 << 32)) % (1 << 32)
    return u32_array(words), n0

