"""The cell cq_tables.sigma2e16 (system cq_tables, traffic
sigma_halves_2e16) on the CPU at a tiny size: the sigma half-tables of
8-bit words (16 rows), the program's device route on the CPU
(static_tables.fk_device giving "cpu"): correct, no device number; one
altered point, the w^i/N scale left out, the previous request's answer and
a neighbouring column's answer (the control) make `correct` false; the
set-up refuses a program that preprocesses on the host or has no device
FK entry.  Then the plain reference against the port at 2^6, the seven
readers on a hand-built record, and fk_work's count at 2^16 by hand."""
import json
import os
import time
from types import SimpleNamespace

import pytest

from cardbench import control, harness
from cardbench.reference import bn254, cq_tables
from cardbench.roofline import fk_work

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CELL = "cq_tables.sigma2e16"
SEED = 2 ** 31 + 47
METRICS = ["fk_host_s.tables", "fk_group_ntt_s.tables", "fk_readback_s.tables",
           "device_idle_pct.tables", "fk_roofline", "h2d_bytes.tables",
           "host_syncs.tables"]
LOG_READERS = {"fk_group_ntt_s.tables", "fk_readback_s.tables",
               "fk_host_s.tables", "h2d_bytes.tables", "host_syncs.tables"}


@pytest.fixture
def tiny(tmp_path, bench, monkeypatch):
    """The cell's configuration and mix at 8-bit words (16-row tables over
    a 64-point SRS), program caches inside tmp_path."""
    monkeypatch.setenv("SHA2CQ_CACHE", str(tmp_path / "cache" / "sha2cq"))
    monkeypatch.setenv("CARDBENCH_CACHE", str(tmp_path / "cache"))
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    cell = next(w for w in bench["workloads"] if w["name"] == CELL)
    with open(os.path.join(ROOT, "cardbench", "configs",
                           cell["config"] + ".json")) as f:
        cfg = json.load(f)
    cfg.update(word_bits=8, table_rows=16, srs_log2=6)
    with open(os.path.join(ROOT, "cardbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        tr = json.load(f)
    tr.update(rows=16)
    (tmp_path / "configs" / f"{cell['config']}.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / f"{cell['traffic']}.json").write_text(json.dumps(tr))
    return tmp_path


@pytest.fixture
def device_path(monkeypatch):
    from sha2cq_tpu_torch.plonk import static_tables as ST
    monkeypatch.setattr(ST, "fk_device", lambda size: "cpu")


def run(tiny, bench, trace=False, seconds=0.5):
    cell = harness.resolve(bench, CELL, base=str(tiny))
    with open(os.devnull, "w") as quiet:
        return harness.run(cell, SEED, seconds, trace, "cpu",
                           time.perf_counter(), out=quiet, err=quiet)


def test_the_cell_resolves(bench):
    cell = harness.resolve(bench, CELL)
    assert cell.system.SPAN == "cq_fk" and cell.cell["chips"] == 1
    assert [m["name"] for m, _ in cell.end_to_end] == ["setup_s",
                                                       "commits_per_s"]
    assert [m["name"] for m, _ in cell.per_layer] == METRICS
    assert cell.config["table_rows"] == 1 << (cell.config["word_bits"] // 2)
    assert len(cell.traffic["tables"]) == 8


@pytest.mark.parametrize("trace", [False, True])
def test_rehearsal(tiny, bench, device_path, trace):
    res = run(tiny, bench, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"] == {} and "breakdown" not in res
    assert not set(res["metrics"]) & set(METRICS)
    assert res["compared"] == {"quotients_wrong": {"value": 0, "limit": 0}}


@pytest.fixture
def served(tiny, bench, device_path):
    """The set-up's state and the answers of four requests over three
    tables, one of them twice."""
    cell = harness.resolve(bench, CELL, base=str(tiny))
    sys_ = cell.system
    state = sys_.setup(cell.config, cell.traffic, SEED, "cpu")
    reqs = [SimpleNamespace(index=i, table=t)
            for i, t in enumerate(["bs0h", "ss1l", "bs0h", "bs1l"])]
    return sys_, state, [(r, sys_.serve(state, r)) for r in reqs]


def wrong(sys_, state, served):
    srs = state.srs_g1
    try:
        return sys_.check(state, served)["quotients_wrong"][0]
    finally:
        state.srs_g1 = srs


def test_the_served_answers_are_right(served):
    sys_, state, good = served
    assert wrong(sys_, state, good) == 0


def test_an_altered_point_is_wrong(served):
    sys_, state, good = served
    for i, j in [(0, 1), (2, 3)]:          # a first answer, a later one
        bad = [(r, [list(c) for c in a]) for r, a in good]
        bad[i][1][j][5] = bn254.to_affine(bn254.jac_add(
            bn254.to_jac(bad[i][1][j][5]), bn254.to_jac(bn254.G1)))
        assert wrong(sys_, state, bad) >= 1


def test_the_scale_left_out_is_wrong(served, monkeypatch):
    from sha2cq_tpu_torch.curves import device as CD
    from sha2cq_tpu_torch.plonk import static_tables as ST
    sys_, state, good = served
    monkeypatch.setattr(ST, "_out_scales",
                        lambda n, device: CD.raw_limbs([1] * n))
    bad = [(r, sys_.serve(state, r)) for r, _ in good]
    assert wrong(sys_, state, bad) == 4 * 5


def test_the_previous_answer_is_wrong(served):
    sys_, state, good = served
    bad = [(good[i][0], good[i - 1][1]) for i in range(1, 4)]
    assert wrong(sys_, state, bad) >= 5


def test_a_neighbouring_column_is_wrong(served):
    sys_, state, good = served
    with sys_.control(state):
        bad = [(r, sys_.serve(state, r)) for r, _ in good]
    assert wrong(sys_, state, bad) == 4 * 5


def test_control_is_not_correct(tiny, bench, device_path):
    cell = harness.resolve(bench, CELL, base=str(tiny))
    res = control.run_control(cell, SEED, 0.5, "cpu")
    assert res["attempted"] >= 1 and not res["correct"]
    assert res["compared"]["quotients_wrong"]["value"] == 5 * res["attempted"]


def test_setup_refuses_the_host_path(tiny, bench, monkeypatch):
    """Without a card the tables take the host route: the set-up raises.
    A program without the device FK entry is refused before the SRS is
    made."""
    cell = harness.resolve(bench, CELL, base=str(tiny))
    with pytest.raises(RuntimeError, match="on the host"):
        cell.system.setup(cell.config, cell.traffic, SEED, "cpu")
    assert os.listdir(tiny / "cache" / "srs")
    from sha2cq_tpu_torch.plonk import static_tables as ST
    monkeypatch.delattr(ST, "fk_cached_quotients")
    monkeypatch.setenv("CARDBENCH_CACHE", str(tiny / "other"))
    with pytest.raises(RuntimeError, match="on the host"):
        cell.system.setup(cell.config, cell.traffic, SEED, "cpu")
    assert not (tiny / "other").exists()


def test_the_reference_equals_the_port():
    from sha2cq_tpu_torch.plonk import static_tables as ST
    from sha2cq_tpu_torch.poly.kzg import params as KP
    s = 0x5BE0CD191F83D9AB9B05688C510E527F % bn254.R
    vals = [(7 * i * i + 3) % 251 for i in range(64)]
    qs = ST.fk_cached_quotients([vals], KP._g1_powers_of_s(s, 64), "cpu")[0]
    c = cq_tables.quotient_scalars(vals, s)
    assert qs == [bn254.mul(bn254.G1, ci) for ci in c]
    assert cq_tables.check_column((vals, qs, s, "t"))
    assert not cq_tables.check_column((vals, qs[1:] + qs[:1], s, "t"))


def test_fk_work_by_hand():
    # per column at N = 2^16: twiddles 2^16 * 17 - (2^17 - 1) and
    # 2^15 * 16 - (2^16 - 1), scalings 2^17 + 2^16
    per = (65536 * 17 - 131071) + (32768 * 16 - 65535) + 131072 + 65536
    assert per == 1_638_402
    assert fk_work.fk_scalar_muls(1 << 16, 5) == 5 * per
    ntt = 32768 * 16 + 65536 * 17
    assert fk_work.fk_products(1 << 16, 5) == 5 * (per * 127 * 7 + ntt) \
        == 7_290_888_890
    assert fk_work.fk_least_seconds(1 << 16, 5) == pytest.approx(
        7_290_888_890 * 264 / 16.75e12)


# -- the readers

def recorded_log():
    """A warm-up table before the window, three tables in it (one request
    a second from 0), and a cq_fk nested in another phase.  A table counts
    its values' bytes and a wait in cq_table_ntt, and one wait in
    cq_readback."""
    from sha2cq_tpu_torch.utils.profiling import Span

    def table(first, t0, ntt, back, up, waits):
        steps = [("cq_table_ntt", 0.01), ("cq_scalar_mul", 0.01),
                 ("cq_group_ntt", ntt), ("cq_scalar_mul", 0.01),
                 ("cq_readback", back)]
        counts = {"cq_table_ntt": {"h2d_bytes": up, "host_syncs": waits},
                  "cq_readback": {"host_syncs": 1}}
        spans, t = [], t0 + 0.01
        for i, (name, dt) in enumerate(steps):
            spans.append(Span(name, f"cq_fk/{name}", t, t + dt, 1, first,
                              first + 1 + i, first, counts.get(name, {})))
            t += dt
        return spans + [Span("cq_fk", "cq_fk", t0, t + 0.01, 1, first, first,
                             None, {})]
    log = table(1, -50.0, 9.0, 9.0, 10 ** 9, 40)
    for i, (ntt, back, up, waits) in enumerate(
            [(0.3, 0.2, 800, 3), (0.5, 0.1, 900, 5), (0.4, 0.3, 700, 4)]):
        log += table(100 * (i + 1), i + 0.05, ntt, back, up, waits)
    return log + [Span("cq_fk", "other/cq_fk", 2.1, 2.2, 1, 500, 501, 500,
                       {"h2d_bytes": 10 ** 9}),
                  Span("other", "other", 2.05, 2.3, 1, 500, 500, None, {})]


def record_of(busy):
    from cardbench.trace import Tracer, merge
    t = Tracer("cuda:0", "cq_fk")
    t.busy = merge(busy, 0.0, 3.0)
    t.busy_s, t.window_s = sum(e - s for s, e in t.busy), 3.0
    t.intervals = [("cq_fk", -50.0, -30.0)] + \
        [("cq_fk", i + 0.05, i + 0.85) for i in range(3)]
    answer = [[None] * (1 << 16)] * 5
    return SimpleNamespace(tracer=t, window=SimpleNamespace(
        spans=[(0.0, 1.0), (1.0, 2.0), (2.0, 3.0)],
        served=[(None, answer)] * 3))


def reader(name):
    return harness.load_module(os.path.join(ROOT, "cardbench", "metrics",
                                            name + ".py"))


@pytest.mark.parametrize("name,want", [
    ("fk_host_s.tables", 0.8 - 0.4),
    ("fk_group_ntt_s.tables", 0.4),
    ("fk_readback_s.tables", 0.2),
    ("device_idle_pct.tables", 100 * (1 - 1.2 / 3.0)),
    ("fk_roofline", 100 * 3 * fk_work.fk_least_seconds(1 << 16, 5) / 1.2),
    ("h2d_bytes.tables", 800.0),
    ("host_syncs.tables", 5.0)])
def test_readers(monkeypatch, name, want):
    from sha2cq_tpu_torch.utils.profiling import profiler
    monkeypatch.setattr(profiler, "log", recorded_log)
    busy = [(0.2, 0.6), (1.2, 1.6), (2.2, 2.6), (-40.0, -35.0)]
    assert reader(name).read(record_of(busy)) == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_readers_find_nothing_to_read(monkeypatch, name):
    """None without a device trace (a CPU run) and, for the span readers,
    on a log and a trace without cq_fk (the parent's program)."""
    from sha2cq_tpu_torch.utils.profiling import profiler
    monkeypatch.setattr(profiler, "log", recorded_log)
    rec = record_of([(0.5, 0.6)])
    rec.tracer.busy = None
    assert reader(name).read(rec) is None
    if name in LOG_READERS:
        monkeypatch.setattr(profiler, "log", lambda: [])
        rec = record_of([(0.5, 0.6)])
        rec.tracer.intervals = []
        assert reader(name).read(rec) is None


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
    assert out["correct"] and set(METRICS) <= set(out["metrics"])
    assert 0 < out["metrics"]["fk_roofline"]["value"] <= 100
