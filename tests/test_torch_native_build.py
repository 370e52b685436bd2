"""The port's native_loader builds native/fieldops.c into a directory of its
own (sha2cq_tpu_torch/_build/native/, never the JAX package's native/build/),
once across concurrent processes, under a lock and through a temporary
file, so no process ever loads a half-written library."""
import os
import shutil
import subprocess
import sys
import time

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
