"""Canonical Fr words of a list of scalars: fr_words(scalars) is
native_loader.fr_buf([s % r for s in scalars]), word for word, in one
native pass over the list (native/scalar_words.c).

The pass takes each element that is an exact int in [0, r), which is
every coefficient of a reduced polynomial, and stops at the first other
one: a negative int, one >= r, a bool, an int subclass, a numpy integer.
Python reduces that element as the parent expression does, and the pass
goes on from the next.  So every input gives fr_buf's words, or the
exception fr_buf's expression raises.

The library is built on first use into sha2cq_tpu_torch/_build/native/
(native_loader.build_locked: one build across processes), against the
running interpreter's headers, and named by a hash of the source and by
the interpreter's SOABI.  Without a compiler or the headers the Python
expression runs instead and `build_error` says why: an accelerator,
never a requirement.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import sysconfig
import warnings
from typing import Optional, Tuple

import numpy as np

from . import native_loader as NL
from .fields.host import FR_MOD

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "native",
                    "scalar_words.c")


def lib_path(source: bytes, soabi: str) -> str:
    """The library's path for a source text and an interpreter's SOABI: a
    changed source, or another interpreter's headers, build anew."""
    digest = hashlib.sha256(source).hexdigest()[:12]
    return os.path.join(NL.BUILD_DIR, f"libscalarwords-{digest}.{soabi}.so")


with open(_SRC, "rb") as _f:
    _LIB = lib_path(_f.read(), sysconfig.get_config_var("SOABI") or "")

_lib = None
_tried = False
build_error: Optional[str] = None   # why this process has no library


def _build() -> Optional[str]:
    """Build _LIB against the interpreter's headers; None or why not."""
    include = sysconfig.get_paths()["include"]
    if not os.path.exists(os.path.join(include, "Python.h")):
        return f"no Python.h in {include}"
    return NL.build_locked(_LIB, ["cc", "-O3", "-shared", "-fPIC",
                                  f"-I{include}", _SRC])


def get_lib() -> Optional[ctypes.PyDLL]:
    """The library, built on first use; None (with `build_error`) when it
    cannot be."""
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_LIB):
        build_error = _build()
        if build_error is not None:
            warnings.warn(f"{_SRC} did not build; Python packs the scalars "
                          f"instead: {build_error}", RuntimeWarning)
            return None
    try:
        lib = ctypes.PyDLL(_LIB)      # keeps the GIL: the pass reads objects
    except OSError as e:
        build_error = f"{_LIB} did not load: {e!r}"
        warnings.warn(build_error, RuntimeWarning)
        return None
    lib.fr_words.argtypes = [ctypes.py_object, ctypes.c_ssize_t,
                             ctypes.c_ssize_t,
                             ctypes.POINTER(ctypes.c_uint64)]
    lib.fr_words.restype = ctypes.c_ssize_t
    _lib = lib
    return lib


def fr_words(scalars) -> Tuple[np.ndarray, int]:
    """(fr_buf([s % r for s in scalars]), the count of scalars that took
    the Python path): all of them without the library."""
    seq = scalars if type(scalars) in (list, tuple) else list(scalars)
    n = len(seq)
    lib = get_lib()
    if lib is None:
        return NL.fr_buf([s % FR_MOD for s in seq]), n
    out = np.empty((n, 4), dtype="<u8")
    ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
    obj = ctypes.py_object(seq)
    i, slow = lib.fr_words(obj, 0, n, ptr), 0
    while i < n:
        try:
            out[i] = np.frombuffer(int(seq[i] % FR_MOD).to_bytes(
                32, "little"), dtype="<u8")
        except Exception:
            # the parent's expression over the whole list raises its own
            # exception (the first `%` that fails comes before any pack)
            NL.fr_buf([s % FR_MOD for s in seq])
            raise
        slow += 1
        i = lib.fr_words(obj, i + 1, n, ptr)
    return out, slow
