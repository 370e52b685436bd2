"""BENCHMARK.json against the harness's files: every cell resolves to its
configuration, traffic, system and metric files; names, units and the
cells' metric lists keep to the benchmark's contract; and a new cell,
configuration, traffic mix and metric work as new files alone."""
import json
import os
import re

import pytest

from cardbench import harness

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def cells(bench):
    return [w["name"] for w in bench["workloads"]]


def test_every_cell_resolves(bench):
    for name in cells(bench):
        cell = harness.resolve(bench, name)
        for attr in ("setup", "request", "serve", "check", "SPAN"):
            assert hasattr(cell.system, attr), (name, attr)
        names = {m["name"] for m, _ in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2, name
        assert cell.per_layer, name
        for _, reader in cell.end_to_end + cell.per_layer:
            assert callable(reader.read)


def test_names_units_and_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["cardbench"]
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    groups = [[c["name"] for c in bench["configs"]], cells(bench),
              [m["name"] for m in metrics]]
    for group in groups:
        assert len(set(group)) == len(group)
    for name in sum(groups, []) + [w["traffic"] for w in bench["workloads"]]:
        assert NAME.match(name), name
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", [])) <= set(cells(bench))
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        assert m["name"].endswith("_roofline") or "roofline" not in m["name"]
        for w in m["workloads"]:
            mover = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
            assert w in mover.get("workloads", [w]), (m["name"], w)
    for w in bench["workloads"]:
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200


def test_configs_state_their_cuts(bench):
    for c in bench["configs"]:
        path = os.path.join(ROOT, c["file"])
        assert c["file"].startswith("cardbench/configs/")
        with open(path) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert sorted(cfg.get("reduced_why", {})) == sorted(c["reduced"])
        for key in c["reduced"]:
            assert cfg["published"][key] != cfg[key]
            assert not key.endswith(("_dim", "_rank"))
        assert cfg["srs_secret"].startswith("0x") and "deployment" in cfg


def test_a_new_cell_is_new_files_only(tmp_path, bench, monkeypatch):
    """A throwaway cell with its own configuration, traffic mix and
    per-layer metric, all new files in a directory of their own, resolves
    and runs on the CPU; no file of the harness changes."""
    monkeypatch.setenv("SHA2CQ_CACHE", str(tmp_path / "cache" / "sha2cq"))
    monkeypatch.setenv("CARDBENCH_CACHE", str(tmp_path / "cache"))
    for d in ("configs", "traffic", "metrics"):
        (tmp_path / d).mkdir()
    with open(os.path.join(ROOT, "cardbench/configs/kzg_commit_srs2e20.json")) as f:
        cfg = json.load(f)
    cfg["srs_log2"] = 9
    (tmp_path / "configs" / "kzg_commit_srs2e9.json").write_text(json.dumps(cfg))
    (tmp_path / "traffic" / "words16_300.json").write_text(json.dumps(
        {"points": 300, "scalars": "words16"}))
    (tmp_path / "metrics" / "requests_served.commit.py").write_text(
        "def read(record):\n    return float(len(record.window.served))\n")
    new = json.loads(json.dumps(bench))
    new["configs"].append({"name": "kzg_commit_srs2e9", "source": cfg["source"],
                           "file": "cardbench/configs/kzg_commit_srs2e9.json",
                           "reduced": [], "why": "a throwaway"})
    new["workloads"].append({"name": "kzg_commit.tiny", "config": "kzg_commit_srs2e9",
                             "traffic": "words16_300", "chips": 1, "why": "a throwaway"})
    new["per_layer"].append({"name": "requests_served.commit", "unit": "requests",
                             "better": "higher", "source": "host_clock",
                             "layer": "harness", "moves": "commits_per_s",
                             "workloads": ["kzg_commit.tiny"]})
    next(m for m in new["end_to_end"]
         if m["name"] == "commits_per_s")["workloads"].append("kzg_commit.tiny")
    before = {p: open(p, "rb").read() for p in _harness_files()}
    cell = harness.resolve(new, "kzg_commit.tiny", base=str(tmp_path))
    res = harness.run(cell, 77, 0.5, True, "cpu", 0.0, out=open(os.devnull, "w"),
                      err=open(os.devnull, "w"))
    assert res["correct"] and res["attempted"] >= 1
    assert res["metrics"]["requests_served.commit"]["value"] == res["attempted"]
    assert before == {p: open(p, "rb").read() for p in _harness_files()}


def _harness_files():
    out = []
    for d, _, files in os.walk(os.path.join(ROOT, "cardbench")):
        if "__pycache__" in d:
            continue
        out += [os.path.join(d, f) for f in files]
    return sorted(out)


def test_missing_file_is_named(bench):
    bad = json.loads(json.dumps(bench))
    bad["workloads"][0]["traffic"] = "no_such_mix"
    with pytest.raises(FileNotFoundError, match="no_such_mix"):
        harness.resolve(bad, bad["workloads"][0]["name"])
