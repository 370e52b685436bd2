"""The port's native_loader builds native/fieldops.c into a directory of its
own (sha2cq_tpu_torch/_build/native/, never the JAX package's native/build/),
once across concurrent processes, under a lock and through a temporary
file, so no process ever loads a half-written library; and the library of
the scalar packing pass (scalar_words), named by its source and the
interpreter's SOABI, built the same way, and its Python fallback."""
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

import sha2cq_tpu_torch
from sha2cq_tpu_torch import native_loader as NL

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHILD = """
import importlib.util, os, subprocess, sys, time
root, log, go = sys.argv[1:4]
real_run = subprocess.run
def counting_run(cmd, *a, **k):
    if cmd and cmd[0] == "cc":
        with open(log, "a") as f:
            f.write(f"{os.getpid()}\\n")
    return real_run(cmd, *a, **k)
subprocess.run = counting_run
spec = importlib.util.spec_from_file_location(
    "port_native_loader", os.path.join(root, "sha2cq_tpu_torch", "native_loader.py"))
NL = importlib.util.module_from_spec(spec)
spec.loader.exec_module(NL)
while not os.path.exists(go):
    time.sleep(0.005)
lib = NL.get_lib()
print(lib is not None, NL._LIB, NL.build_error)
"""


def test_library_lies_in_the_ports_build_directory():
    pkg = os.path.dirname(os.path.abspath(sha2cq_tpu_torch.__file__))
    assert NL.BUILD_DIR == os.path.join(pkg, "_build", "native")
    assert os.path.dirname(NL._LIB) == NL.BUILD_DIR
    assert os.path.join("native", "build") not in NL._LIB
    assert os.path.basename(NL._LIB).startswith("libfieldops-")


def test_four_processes_build_once_and_all_load(tmp_path):
    """Four processes call get_lib() at once on an empty build directory:
    every one loads the library, cc runs once, and the directory holds the
    library and the lock file, no temporary file."""
    (tmp_path / "sha2cq_tpu_torch").mkdir()
    shutil.copy(NL.__file__, tmp_path / "sha2cq_tpu_torch" / "native_loader.py")
    (tmp_path / "native").mkdir()
    shutil.copy(os.path.join(ROOT, "native", "fieldops.c"),
                tmp_path / "native" / "fieldops.c")
    log, go = tmp_path / "cc.log", tmp_path / "go"
    procs = [subprocess.Popen([sys.executable, "-c", CHILD, str(tmp_path),
                               str(log), str(go)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    time.sleep(1.0)       # every child waits for `go` with its module loaded
    go.touch()
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 4, [e for _, e in outs]
    build_dir = tmp_path / "sha2cq_tpu_torch" / "_build" / "native"
    lines = [o.split() for o, _ in outs]
    assert {ln[0] for ln in lines} == {"True"}
    assert {ln[1] for ln in lines} == {
        str(build_dir / os.path.basename(NL._LIB))}
    assert len(log.read_text().split()) == 1
    assert sorted(os.listdir(build_dir)) == sorted(
        ["build.lock", os.path.basename(NL._LIB)])


# -- scalar_words: the library of the scalar packing pass

SW_CHILD = """
import os, subprocess, sys, time
build_dir, log, go = sys.argv[1:4]
real_run = subprocess.run
def counting_run(cmd, *a, **k):
    if cmd and cmd[0] == "cc":
        with open(log, "a") as f:
            f.write(f"{os.getpid()}\\n")
    return real_run(cmd, *a, **k)
subprocess.run = counting_run
from sha2cq_tpu_torch import native_loader as NL
NL.BUILD_DIR = build_dir
from sha2cq_tpu_torch import scalar_words as SW
while not os.path.exists(go):
    time.sleep(0.005)
lib = SW.get_lib()
words, slow = SW.fr_words([5, -1])
print(lib is not None, SW._LIB, SW.build_error, slow)
"""


def test_scalar_words_library_is_named_by_source_and_soabi():
    from sha2cq_tpu_torch import scalar_words as SW
    base = SW.lib_path(b"source", "cpython-312-x86_64-linux-gnu")
    assert os.path.dirname(base) == NL.BUILD_DIR
    assert os.path.basename(base).startswith("libscalarwords-")
    assert SW.lib_path(b"source", "cpython-312-x86_64-linux-gnu") == base
    assert SW.lib_path(b"source!", "cpython-312-x86_64-linux-gnu") != base
    assert SW.lib_path(b"source", "cpython-313-x86_64-linux-gnu") != base
    import sysconfig
    with open(SW._SRC, "rb") as f:
        assert SW._LIB == SW.lib_path(f.read(),
                                      sysconfig.get_config_var("SOABI"))


def test_two_processes_build_the_scalar_words_library_once(tmp_path):
    """Two processes call scalar_words.get_lib() at once on an empty build
    directory: both load the library and take the native pass, cc runs
    once, and the directory holds the library and the lock file."""
    build_dir, log, go = (tmp_path / "build", tmp_path / "cc.log",
                          tmp_path / "go")
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs = [subprocess.Popen([sys.executable, "-c", SW_CHILD, str(build_dir),
                               str(log), str(go)], env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(2)]
    time.sleep(1.0)       # every child waits for `go` with its module loaded
    go.touch()
    outs = [p.communicate(timeout=240) for p in procs]
    assert [p.returncode for p in procs] == [0] * 2, [e for _, e in outs]
    lines = [o.split() for o, _ in outs]
    assert [ln[0] for ln in lines] == ["True", "True"]
    assert lines[0][1] == lines[1][1]
    assert os.path.dirname(lines[0][1]) == str(build_dir)
    assert [ln[-1] for ln in lines] == ["1", "1"]
    assert len(log.read_text().split()) == 1
    assert sorted(os.listdir(build_dir)) == sorted(
        ["build.lock", os.path.basename(lines[0][1])])


@pytest.mark.parametrize("missing", ["compiler", "headers"])
def test_scalar_words_without_compiler_or_headers_packs_in_python(
        tmp_path, monkeypatch, missing):
    """No cc on PATH, or no Python.h where the interpreter says its headers
    are: get_lib() gives None, `build_error` says why, and fr_words gives
    the Python expression's words, every scalar counted as slow."""
    import sysconfig

    from sha2cq_tpu_torch import scalar_words as SW
    from sha2cq_tpu_torch.fields.host import FR_MOD
    monkeypatch.setattr(SW, "_LIB", str(tmp_path / "build" / "lib.so"))
    monkeypatch.setattr(SW, "_lib", None)
    monkeypatch.setattr(SW, "_tried", False)
    monkeypatch.setattr(SW, "build_error", None)
    if missing == "compiler":
        monkeypatch.setenv("PATH", str(tmp_path / "nothing"))
    else:
        paths = dict(sysconfig.get_paths(), include=str(tmp_path))
        monkeypatch.setattr(sysconfig, "get_paths", lambda: paths)
    xs = [3, FR_MOD + 4, -5]
    with pytest.warns(RuntimeWarning, match="did not build"):
        words, slow = SW.fr_words(xs)
    assert SW.get_lib() is None
    assert SW.build_error and ("cc could not run" in SW.build_error
                               if missing == "compiler" else
                               "no Python.h" in SW.build_error)
    assert np.array_equal(words, NL.fr_buf([s % FR_MOD for s in xs]))
    assert slow == 3
    assert not os.path.exists(SW._LIB)
