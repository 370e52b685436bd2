"""Each metric reader on a small recorded set of spans and device
intervals, against the number worked out by hand; and the trace's interval
arithmetic."""
import os
from types import SimpleNamespace

import pytest

from cardbench import harness
from cardbench.roofline import work
from cardbench.trace import Tracer, labels, merge

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def reader(kind, name):
    return harness.load_module(os.path.join(HERE, kind, name + ".py"))


def recorded():
    """Two proofs, 0..3 s and 3..6 s; the device busy 1.0-1.1 and 4.0-4.3
    (inside the proofs' h_device spans 0.9-1.2 and 3.9-4.4) and 5.0-5.1."""
    t = Tracer("cuda:0", "create_proof")
    totals = [{"create_proof/witness_and_advice_commit": 1.0,
               "create_proof/cq_commit_f_m": 0.25,
               "create_proof/cq_log_derivatives": 0.5,
               "create_proof/h_eval_and_commit": 0.4,
               "create_proof/multiopen": 0.75, "create_proof": 2.9,
               "h_pack_inputs": 0.05, "h_unpack": 0.1, "h_device": 0.3,
               "h_pack_inputs/z": 0.01, "gwc_fold": 0.2},
              {"create_proof/witness_and_advice_commit": 2.0,
               "create_proof/cq_commit_f_m": 0.5,
               "create_proof/cq_log_derivatives": 0.5,
               "create_proof/h_eval_and_commit": 0.6,
               "create_proof/multiopen": 0.5, "create_proof": 4.1,
               "h_pack_inputs": 0.1, "h_unpack": 0.1, "h_device": 0.5}]
    t.requests = [{"totals": totals[0]},
                  {"totals": totals[1]}]
    t.intervals = [("h_device", 0.9, 1.2), ("create_proof", 0.0, 3.0),
                   ("h_device", 3.9, 4.4), ("create_proof", 3.0, 6.0)]
    t.ops = [("k3", 1.0, 1.1), ("gemm", 4.0, 4.2), ("k3", 4.15, 4.3),
             ("copy", 5.0, 5.1)]
    t.busy = merge([(s, e) for _, s, e in t.ops], 0.0, 6.0)
    t.busy_s, t.window_s = sum(e - s for s, e in t.busy), 6.0
    window = SimpleNamespace(t0=0.0, t_end=6.0, spans=[(0.0, 3.0), (3.0, 6.0)],
                             served=[("a", b"p"), ("b", b"q")])
    shape = {"n": 4, "ext": 8, "row_products": 3, "input_columns": 2,
             "resident_columns": 1, "advice_columns": 1}
    return SimpleNamespace(tracer=t, window=window, setup_s=12.5,
                           state=SimpleNamespace(work=shape, live=[100, 50]))


def test_trace_intervals():
    rec = recorded()
    assert rec.tracer.busy == [(1.0, 1.1), (4.0, 4.3), (5.0, 5.1)]
    assert rec.tracer.busy_s == pytest.approx(0.5)
    assert rec.tracer.busy_within(0.9, 1.2) == pytest.approx(0.1)
    assert rec.tracer.busy_within(4.1, 6.0) == pytest.approx(0.3)
    segs = labels(rec.tracer.intervals, 0.0, 6.0, "none")
    assert segs[:3] == [(0.0, 0.9, "create_proof"), (0.9, 1.2, "h_device"),
                        (1.2, 3.0, "create_proof")]
    bd = rec.tracer.breakdown(rec.window)
    assert bd["device_ops"][0][0] == "k3"
    assert bd["device_ops"][0][1] == pytest.approx(0.25)
    idle = dict(bd["idle_gaps"])
    # h_device open 0.9-1.2 and 3.9-4.4, busy 1.0-1.1 and 4.0-4.3
    assert idle["h_device"] == pytest.approx(0.2 + 0.2)
    assert idle["create_proof"] == pytest.approx(6.0 - 0.5 - 0.4)


@pytest.mark.parametrize("name,want", [
    ("host_protocol_s.prove", (2.5 + 3.5) / 2),   # medians of 2 are means
    ("cq_s.prove", (0.75 + 1.0) / 2),
    ("h_host_s.prove", (0.15 + 0.2) / 2),
    ("h_device_s.prove", 0.4),
    ("device_idle_pct.prove", 100 * (1 - 0.5 / 6.0)),
    ("device_idle_pct.commit", 100 * (1 - 0.5 / 6.0)),
    ("msm_host_s.commit", ((3.0 - 0.1) + (3.0 - 0.4)) / 2),
])
def test_span_readers(name, want):
    assert reader("metrics", name).read(recorded()) == pytest.approx(want)


def test_roofline_readers():
    rec = recorded()
    # busy inside h_device: 0.1 + 0.3 s, two computations of the shape
    want = 100 * 2 * work.h_least_seconds(rec.state.work) / 0.4
    assert reader("metrics", "h_roofline").read(rec) == pytest.approx(want)
    want = 100 * (work.msm_least_seconds(100) + work.msm_least_seconds(50)) / 0.5
    assert reader("metrics", "msm_roofline").read(rec) == pytest.approx(want)


def test_end_to_end_readers():
    rec = recorded()
    assert reader("end_to_end", "setup_s").read(rec) == 12.5
    assert reader("end_to_end", "proofs_per_hour").read(rec) == pytest.approx(1200.0)
    assert reader("end_to_end", "commits_per_s").read(rec) == pytest.approx(1 / 3)
    # the client's time between spans is not the program's
    rec.window.spans = [(0.0, 2.0), (3.5, 6.0)]
    assert reader("end_to_end", "commits_per_s").read(rec) == pytest.approx(2 / 4.5)


def test_readers_find_nothing_to_read():
    """No device (a CPU run) or no span: the reader returns None, never 0."""
    rec = recorded()
    rec.tracer.busy = None
    for name in ("h_roofline", "msm_roofline", "device_idle_pct.prove",
                 "msm_host_s.commit"):
        assert reader("metrics", name).read(rec) is None
    rec = recorded()
    rec.tracer.intervals = []
    rec.tracer.requests = [{"totals": {}}]
    for name in ("h_roofline", "cq_s.prove", "h_host_s.prove",
                 "h_device_s.prove", "host_protocol_s.prove"):
        assert reader("metrics", name).read(rec) is None
