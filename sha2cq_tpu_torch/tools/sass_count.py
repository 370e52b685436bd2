#!/usr/bin/env python3
"""SASS instruction counts of the port's kernels, by kind.

    python3 -m sha2cq_tpu_torch.tools.sass_count [--parent DIR] [--match RE]

Builds the kernel library (ops/kernels.py; with --parent, also that older
tree's) and runs cuobjdump -sass on it.  For every kernel whose mangled name
matches RE (default: K2's and K4's kernels) it prints one JSON line: the
instructions of the kernel's listing by opcode and by kind -- IMAD (every
IMAD form: the multiplier), ALU (IADD3, LOP3, SHF, PRMT, LEA, ISETP, SEL,
MOV, ...), MEM (global, shared and local loads and stores), CTRL (branches,
calls, barriers, exit) -- and its CALLs, which reach subroutines such as
the 64-bit division.  K2's kernel is straight code for one element, so its
listing is its instruction count per element (a subroutine counted once).
The last line is the card's name and power limit.
"""
import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from collections import Counter

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
KINDS = (("MEM", re.compile(r"^(LDG|STG|LDS|STS|LDL|STL|LD|ST|LDC|ULDC|ATOM|RED)")),
         ("IMAD", re.compile(r"^IMAD")),
         ("CTRL", re.compile(r"^(BRA|CALL|RET|EXIT|BAR|BSSY|BSYNC|WARPSYNC|NOP|BPT)")),
         ("ALU", re.compile(r"^(IADD3|LOP3|SHF|PRMT|LEA|ISETP|SEL|MOV|IABS|POPC|FLO|"
                            r"BREV|IMNMX|VIADD|VIMNMX|P2R|R2P|PLOP3|S2R|S2UR|CS2R|"
                            r"UMOV|UIADD3|ULOP3|USHF|UISETP|USEL|ULEA|UPRMT|UIMAD|"
                            r"SGXT|BMSK|IDP|IMUL|I2F|F2I|FRND|MUFU|FMUL|FFMA|FADD)")))


def kind(opcode: str) -> str:
    for name, pat in KINDS:
        if pat.match(opcode):
            return name
    return "OTHER"


def counts(lib: str, nvcc: str, match: str) -> dict:
    """{mangled kernel name: Counter of opcodes} from cuobjdump -sass."""
    cuobjdump = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    text = subprocess.run([cuobjdump, "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for ln in text.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            name = m.group(1) if re.search(match, m.group(1)) else None
            if name:
                out[name] = Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if name and m:
            out[name][m.group(1)] += 1
    return out


def load_kernels(tree: str):
    spec = importlib.util.spec_from_file_location(
        f"kernels_{abs(hash(tree))}",
        os.path.join(tree, "sha2cq_tpu_torch", "ops", "kernels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", help="an older tree whose kernels are counted too")
    ap.add_argument("--match", default=r"k2_kernel|k4_(pass|stage)")
    args = ap.parse_args()
    trees = [("new", ROOT)] + ([("parent", args.parent)] if args.parent else [])
    for tag, tree in trees:
        K = load_kernels(tree)
        lib = K.build()
        for fn, ops in counts(lib, K.nvcc(), args.match).items():
            by_kind = Counter()
            for op, c in ops.items():
                by_kind[kind(op.split(".")[0])] += c
            print(json.dumps({
                "tree": tag, "kernel": fn, "instructions": sum(ops.values()),
                "by_kind": dict(by_kind), "calls": ops.get("CALL.REL.NOINC", 0) +
                ops.get("CALL.REL", 0) + ops.get("CALL.ABS.NOINC", 0),
                "opcodes": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}),
                flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    sys.exit(main())
