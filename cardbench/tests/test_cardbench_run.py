"""The command itself: without a card, or without the program beside it, it
exits nonzero and prints no result; on a card (marked `card`) each cell's
short run prints a correct result line naming the card."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def command(cwd, workload, seconds=3, env=None):
    return subprocess.run(
        [sys.executable, "cardbench/run.py", "--workload", workload, "--seed",
         str(2 ** 31 + 3), "--seconds", str(seconds), "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=900,
        env={**os.environ, **(env or {})})


def no_result(out: str) -> bool:
    return not any(line.startswith("{") for line in out.splitlines())


def test_no_card_no_result():
    res = command(ROOT, "kzg_commit.2e20", env={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode != 0 and no_result(res.stdout)


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "cardbench"), tmp_path / "cardbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = command(tmp_path, "kzg_commit.2e20")
    assert res.returncode != 0 and no_result(res.stdout)


@pytest.mark.card
@pytest.mark.parametrize("workload", ["kzg_commit.2e20"])
def test_short_run_on_the_card(card, workload):
    import torch
    res = command(ROOT, workload)
    assert res.returncode == 0, res.stderr[-2000:]
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["correct"] and out["failed"] == 0
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert out["device"]["kind"] == torch.cuda.get_device_name(0)
    assert list(out)[-1] == "compared"
    assert res.stderr.strip().splitlines()[-1].startswith("compared ")
