"""The cell kzg_commit.witness2e20 (system witness_commit, traffic
circuit32_advice_2e20) on the CPU at a tiny size: 64-row columns of the
mix's profiles, the program's device path on the CPU (HOST_THRESHOLD
lowered, msm_device_many at c = 4): correct, no device number; a stale
answer, an altered point, half the rows left out and the control make
`correct` false; the set-up refuses a program that commits on the host.
Then the mix's profiles against a fresh derivation from the program's
witness, and the cell's five readers on a hand-built span log."""
import functools
import json
import os
import time
from types import SimpleNamespace

import pytest

from cardbench import control, harness, witness_columns
from cardbench.roofline import work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "kzg_commit.witness2e20"
SEED = 2 ** 31 + 29
K = 6
METRICS = ["msm_host_s.witness", "msm_digits_s.witness",
           "msm_nonzero_digits.witness", "h2d_bytes.witness",
           "msm_witness_roofline"]


@pytest.fixture
def tiny(tmp_path, bench, monkeypatch):
    """The cell's configuration and mix at 2^6 rows (40 used, 12 blinded),
    program caches inside tmp_path."""
    monkeypatch.setenv("SHA2CQ_CACHE", str(tmp_path / "cache" / "sha2cq"))
    monkeypatch.setenv("CARDBENCH_CACHE", str(tmp_path / "cache"))
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    with open(os.path.join(ROOT, "cardbench", "configs",
                           cell["config"] + ".json")) as f:
        cfg = json.load(f)
    cfg.update(k=K, blocks=1, block_rows=40)
    with open(os.path.join(ROOT, "cardbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        tr = json.load(f)
    tr.update(rows=1 << K, used_rows=40)
    (tmp_path / "configs" / f"{cell['config']}.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / f"{cell['traffic']}.json").write_text(json.dumps(tr))
    return tmp_path


@pytest.fixture
def device_path(monkeypatch):
    from sha2cq_tpu_torch.ops import msm as M
    monkeypatch.setattr(M, "HOST_THRESHOLD", 1 << (K - 1))
    monkeypatch.setattr(M, "msm_device_many", functools.partial(
        M.msm_device_many, device="cpu", c=4))


def run(tiny, bench, trace=False, seconds=0.5):
    cell = harness.resolve(bench, CELL, base=str(tiny))
    with open(os.devnull, "w") as quiet:
        return harness.run(cell, SEED, seconds, trace, "cpu",
                           time.perf_counter(), out=quiet, err=quiet)


def test_the_cell_resolves(bench):
    cell = harness.resolve(bench, CELL)
    assert cell.system.SPAN == "kzg_commit_many" and cell.cell["chips"] == 1
    assert [m["name"] for m, _ in cell.end_to_end] == ["setup_s",
                                                       "commits_per_s"]
    assert [m["name"] for m, _ in cell.per_layer] == METRICS
    assert len(cell.traffic["columns"]) == cell.config["advice_columns"]


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(tiny, bench, device_path, trace):
    res = run(tiny, bench, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"] == {} and "breakdown" not in res
    assert not set(res["metrics"]) & set(METRICS)
    assert res["compared"] == {"commits_wrong": {"value": 0, "limit": 0}}


def stale(real):
    first = []

    def fn(*a, **kw):
        out = real(*a, **kw)
        if not first:
            first.append(out)
        return first[0]
    return fn


@pytest.mark.parametrize("fault", ["stale", "altered", "half_left_out"])
def test_broken_path_is_not_correct(tiny, bench, device_path, monkeypatch,
                                    fault):
    from sha2cq_tpu_torch.curves import host as CH
    from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
    real = ParamsKZG.commit_lagrange_many
    faults = {
        "stale": stale(real),
        "altered": lambda self, cols: [CH.g1_add(p, CH.G1_GEN)
                                       for p in real(self, cols)],
        "half_left_out": lambda self, cols: real(
            self, [c[: len(c) // 2] for c in cols]),
    }
    monkeypatch.setattr(ParamsKZG, "commit_lagrange_many", faults[fault])
    res = run(tiny, bench, seconds=1.0)
    assert res["attempted"] >= 1 and not res["correct"]
    assert res["compared"]["commits_wrong"]["value"] >= 1


def test_control_is_not_correct(tiny, bench, device_path):
    cell = harness.resolve(bench, CELL, base=str(tiny))
    res = control.run_control(cell, SEED, 0.5, "cpu")
    assert res["attempted"] >= 1 and not res["correct"]
    assert res["compared"]["commits_wrong"]["value"] == res["attempted"]


def test_setup_refuses_the_host_path(tiny, bench, monkeypatch):
    """With the threshold where it is, the warm-up commits on the host: the
    set-up raises.  A program without msm_device_many is refused before any
    basis is made."""
    cell = harness.resolve(bench, CELL, base=str(tiny))
    with pytest.raises(RuntimeError, match="on the host"):
        cell.system.setup(cell.config, cell.traffic, SEED, "cpu")
    assert os.listdir(tiny / "cache" / "srs")
    from sha2cq_tpu_torch.ops import msm as M
    monkeypatch.delattr(M, "msm_device_many")
    monkeypatch.setenv("CARDBENCH_CACHE", str(tiny / "other"))
    with pytest.raises(RuntimeError, match="on the host"):
        cell.system.setup(cell.config, cell.traffic, SEED, "cpu")
    assert not (tiny / "other").exists()


def test_the_profiles_are_the_witness(bench):
    """The mix's columns are derive_profile's, as its `derived` says."""
    cell = harness.resolve(bench, CELL)
    assert cell.traffic["derived"].startswith(
        "cardbench.witness_columns.derive_profile(8, 20)")
    assert witness_columns.derive_profile(8, 20) == cell.traffic["columns"]


def test_a_request_keeps_its_profile(bench):
    """Request i: column i mod 123's widest value and zeros in the used
    rows, zero rows after them, the blinded rows full width; the same
    words again from the same (seed, i)."""
    tr = harness.resolve(bench, CELL).traffic
    tr = dict(tr, rows=4096, used_rows=72 * 40)
    for i in (0, 48, 109, 123 + 117):
        w = witness_columns.request_words(SEED, i, tr)
        prof = tr["columns"][i % 123]
        used = w[:tr["used_rows"]]
        assert (used[:, 1:] == 0).all()
        assert int(used[:, 0].max()).bit_length() <= prof["bits"]
        assert abs((used[:, 0] == 0).mean() - prof["zero_share"]) < 0.05
        assert (w[tr["used_rows"]:4096 - 12] == 0).all()
        assert (w[-12:, 3] != 0).all()
        assert (w == witness_columns.request_words(SEED, i, tr)).all()


# -- the readers

def trace_of(first, t0, digits, h2d, live):
    """One witness commit's records: kzg_commit_many from t0, under it
    msm_device_many and its steps."""
    from sha2cq_tpu_torch.utils.profiling import Span
    steps = [("msm_basis", 0.05, {"h2d_bytes": h2d - h2d // 3}),
             ("msm_digits", digits, {"h2d_bytes": h2d // 3}),
             ("msm_layout", 0.002, {"msm_nonzero_digits": live}),
             ("msm_bucket_sums", 0.001, {}), ("msm_window_reduce", 0.001, {}),
             ("msm_fold", 0.05, {})]
    spans, t = [], t0 + 0.01
    for i, (name, dt, counts) in enumerate(steps):
        spans.append(Span(name, f"kzg_commit_many/msm_device_many/{name}", t,
                          t + dt, 1, first, first + 2 + i, first + 1, counts))
        t += dt
    return spans + [
        Span("msm_device_many", "kzg_commit_many/msm_device_many", t0 + 0.005,
             t, 1, first, first + 1, first, {"msm_columns": 1}),
        Span("kzg_commit_many", "kzg_commit_many", t0, t + 0.01, 1, first,
             first, None, {})]


def recorded_log():
    """A warm-up before the window, three commits in it (one request a
    second from 0), and a kzg_commit_many nested in another phase."""
    from sha2cq_tpu_torch.utils.profiling import Span
    log = trace_of(1, -50.0, 9.0, 999, 999)
    for i, (dg, h2d, live) in enumerate([(0.02, 96, 1000), (0.03, 96, 1200),
                                         (0.01, 99, 1100)]):
        log += trace_of(100 * (i + 1), i + 0.05, dg, h2d, live)
    return log + [Span("kzg_commit_many", "other/kzg_commit_many", 2.1, 2.2, 1,
                       500, 501, 500, {"h2d_bytes": 5000}),
                  Span("other", "other", 2.05, 2.3, 1, 500, 500, None, {})]


def record_of(busy):
    from cardbench.trace import Tracer, merge
    t = Tracer("cuda:0", "kzg_commit_many")
    t.busy = merge(busy, 0.0, 3.0)
    t.busy_s, t.window_s = sum(e - s for s, e in t.busy), 3.0
    return SimpleNamespace(tracer=t, state=SimpleNamespace(live=[1000, 1200, 1100]),
                           window=SimpleNamespace(
                               spans=[(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)]))


def reader(name):
    return harness.load_module(os.path.join(ROOT, "cardbench", "metrics",
                                            name + ".py"))


@pytest.mark.parametrize("name,want", [
    ("msm_host_s.witness", 1.0 - 0.1),
    ("msm_digits_s.witness", 0.02),
    ("msm_nonzero_digits.witness", 1100.0),
    ("h2d_bytes.witness", 96.0),
    ("msm_witness_roofline", 100 * sum(
        work.msm_least_seconds(v) for v in (1000, 1200, 1100)) / 0.3)])
def test_readers(monkeypatch, name, want):
    from sha2cq_tpu_torch.utils.profiling import profiler
    monkeypatch.setattr(profiler, "log", recorded_log)
    busy = [(0.5, 0.6), (1.5, 1.6), (2.5, 2.6)]
    assert reader(name).read(record_of(busy)) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_readers_find_nothing_to_read(monkeypatch, name):
    """None without a device trace (a CPU run) and, for the span-log
    readers, on a log without kzg_commit_many (the parent's program)."""
    from sha2cq_tpu_torch.utils.profiling import profiler
    monkeypatch.setattr(profiler, "log", recorded_log)
    rec = record_of([(0.5, 0.6)])
    rec.tracer.busy = None
    assert reader(name).read(rec) is None
    if name in METRICS[1:4]:
        monkeypatch.setattr(profiler, "log", lambda: [])
        assert reader(name).read(record_of([(0.5, 0.6)])) is None


@pytest.mark.card
def test_short_run_on_the_card(card):
    import subprocess
    import sys
    res = subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", CELL, "--seed",
         str(SEED), "--seconds", "3", "--trace", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=1800)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["device"]["busy_s"] > 0
    assert set(METRICS) <= set(out["metrics"])
