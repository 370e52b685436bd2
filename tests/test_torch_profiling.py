"""The port's profiler (sha2cq_tpu_torch.utils.profiling): phases, the
SHA2CQ_TORCH_TRACE device trace (the counterpart of the JAX package's
SHA2CQ_JAX_TRACE), the span log and its traces across threads, and that a
traced commit leaves no thread or process behind."""
import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from sha2cq_tpu_torch.utils import profiling
from sha2cq_tpu_torch.utils.profiling import Profiler, Span

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_trace_writes_one_chrome_trace_per_top_level_region(monkeypatch,
                                                            tmp_path):
    monkeypatch.setenv("SHA2CQ_PROFILE", "1")
    monkeypatch.setenv("SHA2CQ_TORCH_TRACE", str(tmp_path / "traces"))
    prof = Profiler()
    for _ in range(2):
        with prof.phase("h_device"):
            with prof.phase("inner"):
                torch.ones(64).cumsum(0)
    files = sorted(p.name for p in (tmp_path / "traces").iterdir())
    assert files == ["h_device.0.json", "h_device.1.json"]
    trace = json.loads((tmp_path / "traces" / files[0]).read_text())
    assert any("cumsum" in ev.get("name", "") for ev in trace["traceEvents"])
    assert set(prof.timings()) == {"h_device", "h_device/inner"}


def test_no_trace_without_the_variable_or_when_disabled(monkeypatch,
                                                        tmp_path):
    monkeypatch.setenv("SHA2CQ_PROFILE", "1")
    monkeypatch.delenv("SHA2CQ_TORCH_TRACE", raising=False)
    with Profiler().phase("a"):
        pass
    monkeypatch.delenv("SHA2CQ_PROFILE")
    monkeypatch.setenv("SHA2CQ_TORCH_TRACE", str(tmp_path))
    prof = Profiler()
    with prof.phase("a"):
        pass
    assert list(tmp_path.iterdir()) == [] and prof.timings() == {}


# -- the span log

def _enabled(monkeypatch):
    monkeypatch.delenv("SHA2CQ_TORCH_TRACE", raising=False)
    prof = Profiler()
    prof.enable()
    return prof


def test_span_log_records_phases_with_trace_and_parent(monkeypatch):
    """Each closed phase is one record: name, path, start and end on
    perf_counter, thread, a trace per root, its opener as parent, and the
    counts taken inside it and not inside a child."""
    prof = _enabled(monkeypatch)
    t0 = time.perf_counter()
    with prof.phase("a"):
        with prof.phase("b"):
            prof.count("h2d_bytes", 64)
            prof.count("host_syncs")
        prof.count("host_syncs")
        with prof.phase("c"):
            pass
    with prof.phase("d"):
        pass
    assert Span._fields == ("name", "path", "start", "end", "thread",
                            "trace", "span", "parent", "counts")
    b, c, a, d = prof.log()
    assert [s.name for s in (a, b, c, d)] == ["a", "b", "c", "d"]
    assert [s.path for s in (a, b, c, d)] == ["a", "a/b", "a/c", "d"]
    assert a.parent is None and a.trace == a.span
    assert b.parent == c.parent == a.span and b.trace == c.trace == a.trace
    assert d.parent is None and d.trace == d.span != a.trace
    assert len({s.span for s in (a, b, c, d)}) == 4
    assert t0 <= a.start <= b.start <= b.end <= c.start <= c.end <= a.end \
        <= d.start <= d.end <= time.perf_counter()
    assert {s.thread for s in (a, b, c, d)} == {threading.get_ident()}
    assert b.counts == {"h2d_bytes": 64, "host_syncs": 1}
    assert a.counts == {"host_syncs": 1} and c.counts == d.counts == {}
    assert prof.counts() == {"h2d_bytes": 64, "host_syncs": 2}
    assert prof.timings()["a/b"] == pytest.approx(b.end - b.start)


def test_marker_sections_are_spans_of_the_opener_trace(monkeypatch):
    """A marker's sections share one trace: the phase open where the marker
    was made (their parent), or a trace of their own."""
    prof = _enabled(monkeypatch)
    mark = prof.marker("proof")
    mark("witness")
    mark("commit")
    with prof.phase("outer"):
        inner = prof.marker("step")
        prof.count("host_syncs")
        inner("x")
    w, cm, x, outer = prof.log()
    assert (w.name, w.path, cm.path) == ("witness", "proof/witness",
                                         "proof/commit")
    assert w.trace == cm.trace and w.parent is cm.parent is None
    assert w.span != cm.span and w.end == cm.start
    assert x.trace == outer.trace and x.parent == outer.span
    assert x.counts == {} and outer.counts == {"host_syncs": 1}
    assert prof.timings()["proof"] == pytest.approx(cm.end - w.start)


def test_span_log_bound_drops_and_resets(monkeypatch):
    """The log keeps the newest LOG_MAX records and counts what it dropped;
    reset() clears the totals and leaves the log, clear_log() empties it."""
    assert profiling.LOG_MAX == 65536
    monkeypatch.setattr(profiling, "LOG_MAX", 4)
    prof = _enabled(monkeypatch)
    for i in range(6):
        with prof.phase(f"p{i}"):
            prof.count("host_syncs")
    assert [s.name for s in prof.log()] == ["p2", "p3", "p4", "p5"]
    assert prof.dropped == 2
    prof.reset()
    assert prof.timings() == {} and prof.counts() == {}
    assert [s.name for s in prof.log()] == ["p2", "p3", "p4", "p5"]
    prof.clear_log()
    assert prof.log() == [] and prof.dropped == 0


def test_disabled_profiler_records_nothing(monkeypatch):
    monkeypatch.delenv("SHA2CQ_PROFILE", raising=False)
    prof = Profiler()
    with prof.phase("a"):
        prof.count("host_syncs")
        prof.marker("m")("x")
        assert prof.trace_id() is None
    assert prof.log() == [] and prof.counts() == {} and prof.timings() == {}
    assert getattr(prof._local, "stack", None) is None   # not even a stack


def test_h_stage_thread_adopts_the_opener_trace(monkeypatch):
    """The prover's h staging thread opens its phases in the trace of the
    phase that started it; started with none open, they start their own."""
    from sha2cq_tpu_torch.fields.host import FR_MOD
    from sha2cq_tpu_torch.native_loader import fr_buf
    from sha2cq_tpu_torch.plonk import device_eval as DE
    from sha2cq_tpu_torch.utils.profiling import profiler
    monkeypatch.setattr(profiler, "_enabled", True)
    profiler.clear_log()
    try:
        n = 64
        cols = [fr_buf([(7 * i + j) % FR_MOD for i in range(n)])
                for j in range(2)]
        with profiler.phase("proof"):
            trace = profiler.trace_id()
            stage = DE.StagedStacks(n, "cpu")
            stage.start({(0, "advice"): cols})
            stage.take()
        stage.start({(0, "instance"): cols})
        stage.take()
        log = profiler.log()
    finally:
        profiler.clear_log()
        profiler.reset()
    advice, proof, instance = log
    assert proof.name == "proof" and proof.trace == trace
    assert advice.name == "h_stage/advice" and advice.trace == trace
    assert advice.parent is None and advice.thread != proof.thread
    assert instance.name == "h_stage/instance"
    assert instance.trace == instance.span != trace


# -- nothing left running

TRACED_COMMIT = r"""
import functools, json, multiprocessing, random, threading
from sha2cq_tpu_torch.ops import msm as M
from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
from sha2cq_tpu_torch.utils.profiling import profiler
M.HOST_THRESHOLD = 16
M.msm_device = functools.partial(M.msm_device, device="cpu", c=4)
params = ParamsKZG.setup_from_toxic_waste(4, 0x5EED)
profiler.enable()
params.commit([random.Random(1).randrange(1 << 254) for _ in range(16)])
names = [s.name for s in profiler.log()]
print(json.dumps([names, threading.active_count(),
                  len(multiprocessing.active_children())]))
"""


def _python(code, **kw):
    env = {k: v for k, v in os.environ.items()
           if k not in ("SHA2CQ_PROFILE", "SHA2CQ_TORCH_TRACE")}
    return subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, **kw)


def test_a_traced_commit_leaves_nothing_running():
    """A process of its own session enables the profiler, commits on the
    CPU through msm_device and reads the log: one thread, no child; once
    it has exited its session holds no process."""
    proc = _python(TRACED_COMMIT, start_new_session=True)
    out, err = proc.communicate(timeout=600)
    assert proc.returncode == 0, err
    names, threads, children = json.loads(out.strip().splitlines()[-1])
    assert names[-2:] == ["msm_device_many", "kzg_commit"]
    assert len(names) == 9
    assert threads == 1 and children == 0
    with pytest.raises(ProcessLookupError):
        os.killpg(proc.pid, 0)


def test_importing_the_commit_path_starts_nothing():
    """A fresh interpreter that imports the profiler and ops/msm has one
    thread, and the profiler registers no exit hook."""
    proc = _python(
        "import atexit, threading\n"
        "n = atexit._ncallbacks()\n"
        "import sha2cq_tpu_torch.utils.profiling\n"
        "hooks = atexit._ncallbacks() - n\n"
        "import sha2cq_tpu_torch.ops.msm\n"
        "print(threading.active_count(), hooks)\n")
    out, err = proc.communicate(timeout=300)
    assert proc.returncode == 0, err
    assert out.split() == ["1", "0"]
