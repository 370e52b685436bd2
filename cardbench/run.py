#!/usr/bin/env python3
"""Run one cell of the port's benchmark on this machine's card.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell is an entry of BENCHMARK.json; its
configuration, traffic, system and metrics are the files named after it
(cardbench/harness.py).  Set-up (timed from this script's start), then
requests back to back for --seconds, then the plain reference on what the
window served.  The last line of standard output is the result object;
the last lines of standard error are the numbers compared, each beside
its limit.  Exits 2, printing no result, without as many CUDA cards as the
cell asks for, and 3 if the process has loaded JAX or the JAX package.
The program's caches live in _cardbench_cache/ at the checkout's root.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "_cardbench_cache")


def card_state() -> str:
    """The card's name, power limit and SM clock, as nvidia-smi reads them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,"
             "clocks.max.sm,temperature.gpu", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()
    if sys.path and os.path.abspath(sys.path[0]) == os.path.dirname(
            os.path.abspath(__file__)):
        sys.path.pop(0)
    sys.path.insert(0, ROOT)
    os.environ["CARDBENCH_CACHE"] = CACHE
    os.environ["SHA2CQ_CACHE"] = os.path.join(CACHE, "sha2cq")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
    from cardbench import harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        cell = harness.resolve(json.load(f), args.workload)
    chips = cell.cell["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cardbench: the cell needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"[cardbench] card {card_state()}", flush=True)
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda:0", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"cardbench: the process loaded {bad}", file=sys.stderr)
        return 3
    print(f"[cardbench] card {card_state()}", flush=True)
    result["device"] = {"platform": "gpu",
                        "kind": torch.cuda.get_device_name(0),
                        "count": chips, **result["device"]}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
