#!/usr/bin/env python3
"""The controls of the benchmark's output checks, run like a cell.

    python3 cardbench/control.py --workload <cell> --seeds a,b,c --seconds <s>

runs the cell as cardbench/run.py does, once for each seed, with the
control in the program's place, and prints each seed's compared numbers;
the check has to come out not correct.  Each system module states its own
control as `control(state)`, a context manager that puts it in the
program's place for the span of one request.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time


def run_control(cell, seed: int, seconds: float, device: str) -> dict:
    """One run of `cell` with its control serving the window (set-up runs
    the program itself)."""
    from cardbench import harness
    system = cell.system

    class Wrapped:
        SPAN = system.SPAN
        setup, request = staticmethod(system.setup), staticmethod(system.request)
        check = staticmethod(system.check)

        @staticmethod
        def serve(state, req):
            with system.control(state):
                return system.serve(state, req)

    cell.system = Wrapped
    try:
        with open(os.devnull, "w") as quiet:
            return harness.run(cell, seed, seconds, False, device,
                               time.perf_counter(), out=quiet, err=quiet)
    finally:
        cell.system = system


def main() -> int:
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args()
    sys.path.insert(0, root)
    os.environ["CARDBENCH_CACHE"] = os.path.join(root, "_cardbench_cache")
    os.environ["SHA2CQ_CACHE"] = os.path.join(root, "_cardbench_cache", "sha2cq")
    import torch

    from cardbench import harness
    if not torch.cuda.is_available():
        print("cardbench control: no CUDA card", file=sys.stderr)
        return 2
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        cell = harness.resolve(json.load(f), args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        res = run_control(cell, seed, args.seconds, "cuda:0")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "control_correct": res["correct"],
                          "attempted": res["attempted"],
                          "compared": res["compared"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
