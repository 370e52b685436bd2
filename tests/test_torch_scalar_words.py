"""scalar_words.fr_words, the native pass that packs a commit's scalars,
against the expression it stands for, native_loader.fr_buf([s % r for s in
scalars]): the same words, or the same exception, for canonical ints, for
every kind of element the pass leaves to Python, and for the sequences
msm_device is given; with the library, with its public-call branch, and
with the library absent (the Python fallback)."""
import ctypes
import os
import random
import subprocess
import sysconfig

import numpy as np
import pytest

from sha2cq_tpu_torch import native_loader as NL
from sha2cq_tpu_torch import scalar_words as SW
from sha2cq_tpu_torch.fields.host import FR_MOD


class Int(int):
    """An int subclass: the pass leaves it to Python."""


def _mixed(n, seed):
    rng = random.Random(seed)
    kinds = [lambda: rng.randrange(FR_MOD), lambda: rng.randrange(FR_MOD),
             lambda: rng.randrange(FR_MOD, 1 << 256),
             lambda: -rng.randrange(1 << 300), lambda: rng.randrange(1 << 64),
             lambda: Int(rng.randrange(FR_MOD)), lambda: rng.random() < 0.5,
             lambda: rng.randrange(1 << 256, 1 << 400)]
    return [rng.choice(kinds)() for _ in range(n)]


CASES = {
    "zero": [0], "one": [1], "r-1": [FR_MOD - 1], "r": [FR_MOD],
    "r+1": [FR_MOD + 1], "2^256-1": [(1 << 256) - 1], "2^300": [1 << 300],
    "-1": [-1], "-r": [-FR_MOD], "True": [True],
    "numpy.uint64": [np.uint64(5)], "int subclass": [Int(7)],
    "mixed 2^16": _mixed(1 << 16, 16), "tuple": tuple(_mixed(64, 3)),
    "empty": [], "None": [1, None, 2], "nan": [1, float("nan")],
    "float": [2, 1.5], "canonical around r": [
        FR_MOD - 1, 1 << 253, (1 << 254) - 1, 1 << 240, (1 << 210) + 7, 3],
}


def _canonical(s) -> bool:
    return type(s) is int and 0 <= s < FR_MOD


def _parent(xs):
    """What the expression fr_words stands for gives: words or exception."""
    try:
        return NL.fr_buf([s % FR_MOD for s in xs])
    except Exception as e:
        return type(e)


@pytest.fixture(params=["library", "fallback"])
def route(request, monkeypatch):
    if request.param == "library":
        assert SW.get_lib() is not None, SW.build_error
    else:
        monkeypatch.setattr(SW, "_lib", None)
        monkeypatch.setattr(SW, "_tried", True)
    return request.param


@pytest.mark.parametrize("case", list(CASES))
def test_words_and_slow_count_equal_the_parents(route, case):
    xs = CASES[case]
    want = _parent(xs)
    if isinstance(want, type):
        with pytest.raises(want):
            SW.fr_words(xs)
        return
    got, slow = SW.fr_words(xs)
    assert got.dtype == want.dtype and got.shape == (len(xs), 4)
    assert np.array_equal(got, want)
    assert slow == (len(xs) if route == "fallback" else
                    sum(not _canonical(s) for s in xs))


def test_an_iterable_that_is_no_list_is_read_once_in_order():
    xs = _mixed(100, 5)
    got, slow = SW.fr_words(iter(xs))
    assert np.array_equal(got, NL.fr_buf([s % FR_MOD for s in xs]))
    assert slow == sum(not _canonical(s) for s in xs)


def test_a_list_grown_while_packed_is_read_only_to_its_first_length():
    """A scalar whose `%` appends to the list being packed: the pass stops
    at the list's length when fr_words was called (the rows of its
    output), so it never writes past them."""
    xs = []

    class Grow(int):
        def __mod__(self, m):
            xs.extend([FR_MOD - 1] * 1000)
            return int(self) % m

    xs += [3, Grow(4), 5]
    got, slow = SW.fr_words(xs)
    assert len(xs) == 1003 and slow == 1
    assert np.array_equal(got, NL.fr_buf([3, 4, 5]))


def test_the_public_call_branch_gives_the_same_words(tmp_path):
    """The library built with the interpreter's public call in place of
    CPython 3.12's digits (SCALAR_WORDS_PUBLIC_API) stops at the same
    elements and writes the same words."""
    lib_file = tmp_path / "libpublic.so"
    res = subprocess.run(
        ["cc", "-O3", "-shared", "-fPIC", "-DSCALAR_WORDS_PUBLIC_API",
         f"-I{sysconfig.get_paths()['include']}", SW._SRC, "-o",
         str(lib_file)], capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    public = ctypes.PyDLL(str(lib_file))
    public.fr_words.argtypes = [ctypes.py_object, ctypes.c_ssize_t,
                                ctypes.c_ssize_t,
                                ctypes.POINTER(ctypes.c_uint64)]
    public.fr_words.restype = ctypes.c_ssize_t
    xs = CASES["mixed 2^16"][:4096] + CASES["canonical around r"]
    words = {}
    for name, lib in (("digits", SW.get_lib()), ("public", public)):
        out = np.zeros((len(xs), 4), dtype="<u8")
        ptr = out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))
        stops, i = [], lib.fr_words(ctypes.py_object(xs), 0, len(xs), ptr)
        while i < len(xs):
            stops.append(i)
            out[i] = 0
            i = lib.fr_words(ctypes.py_object(xs), i + 1, len(xs), ptr)
        words[name] = (out, stops)
    assert words["public"][1] == words["digits"][1] == [
        i for i, s in enumerate(xs) if not _canonical(s)]
    assert np.array_equal(words["public"][0], words["digits"][0])
    want = NL.fr_buf([s if _canonical(s) else 0 for s in xs])
    assert np.array_equal(words["digits"][0], want)


def test_the_library_loads_where_the_build_puts_it():
    assert SW.get_lib() is not None, SW.build_error
    assert os.path.dirname(SW._LIB) == NL.BUILD_DIR
    assert os.path.exists(SW._LIB)
