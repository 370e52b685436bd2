"""pytest settings of the benchmark's own tests: the `card` marker, for
tests that need a CUDA card and skip without one (deciding inside the
test), and the tiny CPU cells the rehearsals run.

Besides BENCHMARK.json's cells the rehearsals run the SHA-256 prove cell
that the benchmark does not hold yet (its 32-bit CQ tables take longer to
build than a run may): its system, plain verifier and metric readers are
here, held at a test size (k=9, one block of 8-bit words), with the entries
a later BENCHMARK.json would carry (`PROVE`)."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# systems/prove.key_sha256 of the tiny prove cell's key (k=9, 8-bit words)
TINY_KEY = "158646b04846f1ddb44a27763b0008526ae536c80802e5de955a53eb187968a0"


def _prove_metric(name, unit, better, source, layer):
    return {"name": name, "unit": unit, "better": better, "source": source,
            "layer": layer, "moves": "proofs_per_hour",
            "workloads": ["sha256.prove"]}


PROVE = {
    "config": {
        "system": "prove",
        "source": "https://github.com/aleph-zero-foundation/sha2-on-cq-halo2",
        "deployment": "A SHA-256 preimage-proving service, at a test size.",
        "k": 9, "blocks": 1, "word_bits": 8, "multiopen": "gwc",
        "h_route": "auto",
        "srs_secret": "0x2b7e151628aed2a6abf7158809cf4f3c762e7160f38b4da56a784d9045190cfe",
        "key_sha256": TINY_KEY},
    "traffic": {"about": "Each proof: the configuration's number of chained "
                         "16-word blocks of uniform random words drawn from "
                         "(seed, index), their chaining value as the "
                         "instance, the prover's rng from (seed, index)."},
    "configs": [{"name": "sha256_circuit32_tiny", "source":
                 "https://github.com/aleph-zero-foundation/sha2-on-cq-halo2",
                 "file": "cardbench/configs/sha256_circuit32_tiny.json",
                 "reduced": [], "why": "the prove cell at a test size"}],
    "workloads": [{"name": "sha256.prove", "config": "sha256_circuit32_tiny",
                   "traffic": "random_blocks", "chips": 1,
                   "why": "one prover, proofs back to back"}],
    "end_to_end": [{"name": "proofs_per_hour", "unit": "proofs/h",
                    "better": "higher", "bound": 0.25, "source": "host_clock",
                    "workloads": ["sha256.prove"]}],
    "per_layer": [
        _prove_metric("host_protocol_s.prove", "s", "lower", "program_span",
                      "plonk.prover host protocol"),
        _prove_metric("cq_s.prove", "s", "lower", "program_span",
                      "plonk.static_lookup CQ"),
        _prove_metric("h_host_s.prove", "s", "lower", "program_span",
                      "plonk.device_eval host side"),
        _prove_metric("h_device_s.prove", "s", "lower", "program_span",
                      "plonk.device_eval h module on the card"),
        _prove_metric("h_roofline", "%", "higher", "device_trace", "kernels"),
        _prove_metric("device_idle_pct.prove", "%", "lower", "device_trace",
                      "device")],
}


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.fixture
def bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


@pytest.fixture
def bench_with_prove(bench):
    """BENCHMARK.json with the prove cell's entries added."""
    out = json.loads(json.dumps(bench))
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        out[key] += PROVE[key]
    return out


@pytest.fixture
def tiny(tmp_path, bench, monkeypatch):
    """A directory of the benchmark's configurations and traffic cut to CPU
    sizes (2^10 SRS points, 1000 a commit) and the prove cell's, program
    caches inside it."""
    monkeypatch.setenv("SHA2CQ_CACHE", str(tmp_path / "cache" / "sha2cq"))
    monkeypatch.setenv("CARDBENCH_CACHE", str(tmp_path / "cache"))
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    for c in bench["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        if cfg["system"] == "commit":
            cfg["srs_log2"] = 10
        (tmp_path / "configs" / f"{c['name']}.json").write_text(json.dumps(cfg))
    for w in bench["workloads"]:
        src = os.path.join(ROOT, "cardbench", "traffic", w["traffic"] + ".json")
        with open(src) as f:
            tr = json.load(f)
        if "points" in tr:
            tr["points"] = 1000
        (tmp_path / "traffic" / f"{w['traffic']}.json").write_text(json.dumps(tr))
    (tmp_path / "configs" / "sha256_circuit32_tiny.json").write_text(
        json.dumps(PROVE["config"]))
    (tmp_path / "traffic" / "random_blocks.json").write_text(
        json.dumps(PROVE["traffic"]))
    return tmp_path
