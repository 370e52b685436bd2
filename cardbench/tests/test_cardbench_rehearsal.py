"""The whole run of each cell, and of the prove cell the benchmark does not
hold yet, on the CPU at a tiny size (1000-point commits; k=9 and one block
of 8-bit words), past the look for a card: correct, no device number;
then the same run with the timed path broken underneath, once for each
fault the cell can have, and with each cell's control in the program's
place: `correct` comes out false every time."""
import os
import time

import pytest

from cardbench import control, harness

SEED = 2 ** 31 + 11
DEVICE_METRICS = {"h_roofline", "msm_roofline", "device_idle_pct.prove",
                  "device_idle_pct.commit", "msm_host_s.commit"}


def run(tiny, bench, workload, trace=False, seconds=0.5):
    cell = harness.resolve(bench, workload, base=str(tiny))
    with open(os.devnull, "w") as quiet:
        return harness.run(cell, SEED, seconds, trace, "cpu",
                           time.perf_counter(), out=quiet, err=quiet)


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("workload", ["sha256.prove", "kzg_commit.2e20"])
def test_rehearsal(tiny, bench_with_prove, workload, trace):
    res = run(tiny, bench_with_prove, workload, trace)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert res["device"] == {} and "breakdown" not in res
    assert not set(res["metrics"]) & DEVICE_METRICS
    if not trace:
        assert "setup_s" in res["metrics"] and len(res["metrics"]) == 2
    elif workload == "sha256.prove":
        assert {"host_protocol_s.prove", "cq_s.prove", "h_device_s.prove",
                "h_host_s.prove"} <= set(res["metrics"])
    assert list(res)[-1] == "compared"
    assert all(c["value"] == 0 and c["limit"] == 0
               for c in res["compared"].values())


def stale(real):
    """A step that does its work and returns its first answer again."""
    first = []

    def fn(*a, **kw):
        out = real(*a, **kw)
        if not first:
            first.append(out)
        return first[0]
    return fn


def commit_faults():
    from sha2cq_tpu_torch.curves import host as CH
    from sha2cq_tpu_torch.poly.kzg.params import ParamsKZG
    real = ParamsKZG.commit
    return ParamsKZG, "commit", {
        "stale": stale(real),
        "altered": lambda self, c: CH.g1_add(real(self, c), CH.G1_GEN),
        "half_left_out": lambda self, c: real(self, list(c)[: len(c) // 2]),
    }


def prove_faults():
    from sha2cq_tpu_torch import plonk
    real = plonk.create_proof

    def altered(*a, **kw):
        proof = bytearray(real(*a, **kw))
        proof[len(proof) // 2] ^= 0x01
        return bytes(proof)
    return plonk, "create_proof", {"stale": stale(real), "altered": altered}


@pytest.mark.parametrize("workload,fault", [
    ("kzg_commit.2e20", "stale"), ("kzg_commit.2e20", "altered"),
    ("kzg_commit.2e20", "half_left_out"),
    ("sha256.prove", "stale"), ("sha256.prove", "altered")])
def test_broken_path_is_not_correct(tiny, bench_with_prove, monkeypatch, workload, fault):
    owner, attr, faults = (commit_faults() if workload.startswith("kzg")
                           else prove_faults())
    monkeypatch.setattr(owner, attr, faults[fault])
    res = run(tiny, bench_with_prove, workload, seconds=1.0)
    assert res["attempted"] >= 1 and not res["correct"]
    assert sum(c["value"] for c in res["compared"].values()) >= 1


@pytest.mark.parametrize("workload,answers", [
    ("kzg_commit.2e20", "commits_wrong"), ("sha256.prove", "proofs_rejected")])
def test_control_is_not_correct(tiny, bench_with_prove, workload, answers):
    cell = harness.resolve(bench_with_prove, workload, base=str(tiny))
    res = control.run_control(cell, SEED, 0.5, "cpu")
    assert res["attempted"] >= 1 and not res["correct"]
    assert res["compared"][answers]["value"] == res["attempted"]


def test_another_key_is_not_correct(tiny, bench_with_prove):
    """A key other than the configuration's pinned one fails the check,
    whatever its proofs say."""
    cell = harness.resolve(bench_with_prove, "sha256.prove", base=str(tiny))
    cell.config["key_sha256"] = "0" * 64
    with open(os.devnull, "w") as quiet:
        res = harness.run(cell, SEED, 0.5, False, "cpu", time.perf_counter(),
                          out=quiet, err=quiet)
    assert not res["correct"] and res["compared"]["key_differs"]["value"] == 1
    assert res["compared"]["proofs_rejected"]["value"] == 0


def test_a_changed_table_is_not_correct(tiny, bench_with_prove, monkeypatch):
    """A key whose XOR table has one row wrong (as a keygen over other
    tables would make) differs from the pinned key and from the plain
    tables."""
    cell = harness.resolve(bench_with_prove, "sha256.prove", base=str(tiny))
    real = cell.system.export_key

    def wrong(state):
        key = real(state)
        key["tables"]["s256_8_xorp_z"][-1] ^= 1
        return key
    monkeypatch.setattr(cell.system, "export_key", wrong)
    with open(os.devnull, "w") as quiet:
        res = harness.run(cell, SEED, 0.5, False, "cpu", time.perf_counter(),
                          out=quiet, err=quiet)
    assert not res["correct"]
    assert res["compared"]["key_differs"]["value"] == 1
    assert res["compared"]["tables_differ"]["value"] == 1
