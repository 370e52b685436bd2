"""The commit path's spans and counters in the port's span log
(ParamsKZG.commit -> ops/msm.msm_device, one column of msm_device_many,
on the CPU, window bits 4), and
the benchmark's five readers of that log (cardbench/metrics/*.commit.py,
cardbench/commit_log.py) on hand-built logs."""
import functools
import os
import random
from types import SimpleNamespace

import pytest

from cardbench import harness
from sha2cq_tpu_torch.fields import device as D
from sha2cq_tpu_torch.fields.host import FR_MOD
from sha2cq_tpu_torch.ops import msm as M
from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
from sha2cq_tpu_torch.utils import profiling
from sha2cq_tpu_torch.utils.profiling import Span, profiler

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ["msm_basis", "msm_scalars", "msm_digits", "msm_layout",
         "msm_bucket_sums", "msm_window_reduce", "msm_fold"]
N = 16
COEFFS = [random.Random(5).randrange(1 << 254) for _ in range(N)]
# the nonzero 4-bit window digits of the coefficients' canonical words
DIGITS = sum((s % FR_MOD) >> (4 * w) & 15 != 0 for s in COEFFS
             for w in range(64))


@pytest.fixture(scope="module")
def params():
    return ParamsKZG.setup_from_toxic_waste(4, 0x5EED1234)


@pytest.fixture
def commit(monkeypatch, params):
    """ParamsKZG.commit of N coefficients through msm_device on the CPU
    (c = 4), with the port's profiler on and the device basis cache empty;
    run(commits) commits that many times and returns the last commitment,
    the host MSM's of the same coefficients and the last commit's span
    log."""
    monkeypatch.setattr(M, "HOST_THRESHOLD", N)
    monkeypatch.setattr(M, "msm_device", functools.partial(
        M.msm_device, device="cpu", c=4))
    # a new packed basis, with no device words yet
    monkeypatch.delitem(params.__dict__, "_g_packed", raising=False)
    monkeypatch.setattr(profiler, "_enabled", True)

    def run(commits=1):
        try:
            for _ in range(commits):
                profiler.clear_log()
                point = params.commit(COEFFS)
            return point, M.msm_host(COEFFS, params.g), profiler.log()
        finally:
            profiler.clear_log()
            profiler.reset()
    return run


def test_commit_opens_the_seven_steps_under_one_trace(commit):
    point, want, log = commit()
    assert point == want
    root, many = log[-1], log[-2]
    assert root.name == "kzg_commit" and root.parent is None
    assert root.trace == root.span
    assert many.name == "msm_device_many" and many.parent == root.span
    assert many.trace == root.trace
    steps = log[:-2]
    assert [s.name for s in steps] == STEPS
    assert all(s.parent == many.span and s.trace == root.trace for s in steps)
    assert root.start <= many.start <= steps[0].start
    assert all(a.end <= b.start for a, b in zip(steps, steps[1:]))
    assert steps[-1].end <= many.end <= root.end
    covered = sum(s.end - s.start for s in steps)
    assert covered >= 0.95 * (root.end - root.start)


@pytest.mark.parametrize("commits", [1, 2], ids=["first", "later"])
def test_commit_counts_copies_and_waits_as_on_a_card(commit, monkeypatch,
                                                      commits):
    """With every tensor taken for a card's: the digits' words copied up
    (32 bytes a point, one wait), the layout's read of the nonzero digits
    while the profiler is on (one wait) and the fold's one read-back of X,
    Y and Z together (one wait); the card's K5 and K6 copy nothing.  The
    first commit over the basis also fills the device basis cache in
    msm_basis: the basis (64 bytes a point, and the Montgomery one and
    R^2, 64 bytes each: three waits) and K5's input check (its Montgomery
    one and its answer: two waits), so it counts 96 N + 192 bytes and 8
    waits.  A later commit finds the words in the cache (basis_cached 1):
    32 N bytes and 3 waits."""
    monkeypatch.setattr(D, "on_card", lambda t: True)
    point, want, log = commit(commits)
    assert point == want
    by = {s.name: s.counts for s in log}
    assert by["msm_digits"] == {"h2d_bytes": 32 * N, "host_syncs": 1}
    if commits == 1:
        assert by["msm_basis"] == {"h2d_bytes": 64 * N + 192,
                                   "host_syncs": 5, "basis_cached": 0}
    else:
        assert by["msm_basis"] == {"basis_cached": 1}
    assert by["msm_fold"] == {"host_syncs": 1}
    assert by["msm_layout"] == {"host_syncs": 1, "msm_nonzero_digits": DIGITS}
    assert by["msm_device_many"] == {"msm_columns": 1}
    assert by["kzg_commit"] == {}
    assert by["msm_scalars"] == {"scalars_slow": 0}
    card = [by["msm_digits"], by["msm_basis"], by["msm_layout"],
            by["msm_fold"]]
    bytes_up = sum(c.get("h2d_bytes", 0) for c in card)
    waits = sum(c["host_syncs"] for c in card if "host_syncs" in c)
    assert (bytes_up, waits) == ((96 * N + 192, 8) if commits == 1 else
                                 (32 * N, 3))


def test_commit_counts_nothing_on_the_cpu(commit):
    """No copy and no wait on the CPU: the counts are msm_scalars' slow
    scalars, none for canonical coefficients, msm_basis' basis_cached, 0
    on the commit that fills the cache, msm_layout's nonzero digits and
    msm_device_many's one column."""
    _, _, log = commit()
    counted = {"msm_scalars": {"scalars_slow": 0},
               "msm_basis": {"basis_cached": 0},
               "msm_layout": {"msm_nonzero_digits": DIGITS},
               "msm_device_many": {"msm_columns": 1}}
    assert all(s.counts == {} for s in log if s.name not in counted)
    for name, counts in counted.items():
        assert [s.counts for s in log if s.name == name] == [counts]


# -- the readers

def reader(name):
    return harness.load_module(os.path.join(ROOT, "cardbench", "metrics",
                                            name + ".py"))


def commit_trace(first, t0, scalars, basis, fold, h2d, syncs):
    """One commit's records: kzg_commit from t0, under it msm_device_many
    and its steps in order, the counts split over basis, digits, layout and
    fold."""
    spans, t, sid = [], t0 + 0.01, first + 2
    times = {"msm_basis": basis, "msm_scalars": scalars, "msm_digits": 0.01,
             "msm_layout": 0.002, "msm_bucket_sums": 0.003,
             "msm_window_reduce": 0.001, "msm_fold": fold}
    counts = {"msm_basis": {"h2d_bytes": h2d - h2d // 3, "host_syncs": 3},
              "msm_digits": {"h2d_bytes": h2d // 3, "host_syncs": 1},
              "msm_layout": {"host_syncs": 1, "msm_nonzero_digits": 7},
              "msm_fold": {"host_syncs": syncs - 5}}
    for name in STEPS:
        spans.append(Span(name, f"kzg_commit/msm_device_many/{name}", t,
                          t + times[name], 1, first, sid, first + 1,
                          counts.get(name, {})))
        t += times[name]
        sid += 1
    return spans + [
        Span("msm_device_many", "kzg_commit/msm_device_many", t0 + 0.005, t,
             1, first, first + 1, first, {"msm_columns": 1}),
        Span("kzg_commit", "kzg_commit", t0, t + 0.01, 1, first, first, None,
             {})]


def recorded_log():
    """A warm-up commit before the window, three in it (one request a
    second from 0), a kzg_commit nested in another phase, and a root of
    another name."""
    log = commit_trace(1, -50.0, 9.0, 9.0, 9.0, 999, 99)
    for i, (sc, ba, fo, h2d, sy) in enumerate([
            (0.5, 0.1, 0.05, 96, 9), (0.4, 0.08, 0.06, 96, 9),
            (0.45, 0.09, 0.04, 99, 10)]):
        log += commit_trace(100 * (i + 1), i + 0.05, sc, ba, fo, h2d, sy)
    log += [Span("kzg_commit", "other/kzg_commit", 2.1, 2.2, 1, 500, 501,
                  500, {"host_syncs": 50}),
            Span("other", "other", 2.05, 2.3, 1, 500, 500, None, {}),
            Span("msm_scalars", "msm_scalars", 0.2, 0.3, 2, 600, 600, None,
                 {})]
    return log


def record_of(busy=()):
    return SimpleNamespace(tracer=SimpleNamespace(busy=list(busy)),
                           window=SimpleNamespace(
                               spans=[(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)]))


@pytest.mark.parametrize("name,want", [
    ("msm_scalars_s.commit", 0.45), ("msm_basis_s.commit", 0.09),
    ("msm_fold_s.commit", 0.05), ("h2d_bytes.commit", 96.0),
    ("host_syncs.commit", 9.0)])
def test_commit_log_readers(monkeypatch, name, want):
    monkeypatch.setattr(profiler, "log", recorded_log)
    assert reader(name).read(record_of([(0.5, 0.6)])) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "msm_scalars_s.commit", "msm_basis_s.commit", "msm_fold_s.commit",
    "h2d_bytes.commit", "host_syncs.commit"])
def test_commit_log_readers_find_nothing_to_read(monkeypatch, name):
    """None on an empty log, without a device trace (a CPU run) and with a
    program that keeps no span log."""
    read = reader(name).read
    monkeypatch.setattr(profiler, "log", lambda: [])
    assert read(record_of()) is None
    monkeypatch.setattr(profiler, "log", recorded_log)
    rec = record_of()
    rec.tracer.busy = None
    assert read(rec) is None
    monkeypatch.setattr(profiling, "profiler", SimpleNamespace())
    assert read(record_of()) is None
