#!/usr/bin/env python3
"""Phase-3 kernel checks of two checkouts on one card, in turns.

    python3 tools/kernel_turns.py --base DIR [--checks NAME:DT,...]

Runs ``chip_smoke.py``'s phase-3 checks (each kernel against its plain
version: error, planted faults, device time by CUDA events) from the
checkout at DIR (the base) and from this one (the head), each in a process
of its own that builds its own kernels from its own sources, in the order
base, head, head, base, so that drift of the card's clocks falls on both
sides alike.  Prints one line per check and run, then one JSON line: per
check, each side's mean kernel ms, head / base, and each side's rel-L2
and planted-fault readings.  Needs an NVIDIA GPU.  The default checks are
K1-K3's (``residual_stack``, ``plms_ladder``, ``vocoder_tail``).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HEAD = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT = ("residual_stack:f32,residual_stack:bf16,plms_ladder:f32,"
           "plms_ladder:bf16,vocoder_tail:f32")
MARK = "TURN "


def child(root: str, checks) -> int:
    """Run the checks with ``root``'s chip_smoke and print their readings."""
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as cs

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    # B=1 checks only (a check with a fourth element runs at that batch)
    fns = {(c[0], c[1]): c[2] for c in cs.CHECKS if len(c) == 3}
    for name, dt in checks:
        res = fns[(name, dt)](device, dt)
        print(MARK + json.dumps({
            "check": f"{name}:{dt}", "ms": res["ms"],
            "plain_ms": res["plain_ms"], "rel_l2": res["rel_l2"],
            "fault_rel_l2": res["fault_rel_l2"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


def run(root: str, checks: str) -> list:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", root, "--checks", checks],
                          capture_output=True, text=True, cwd=root)
    if proc.returncode != 0:
        raise SystemExit(f"kernel_turns: the checks of {root} failed "
                         f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return [json.loads(line[len(MARK):]) for line in proc.stdout.splitlines()
            if line.startswith(MARK)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--checks", default=DEFAULT,
                    help="comma-separated NAME:DT of chip_smoke.CHECKS")
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    checks = [tuple(c.split(":")) for c in args.checks.split(",")]
    if args.child:
        return child(args.child, checks)
    if not args.base:
        ap.error("--base is required")
    sides = {"base": os.path.abspath(args.base), "head": HEAD}
    runs = {"base": [], "head": []}
    for side in ("base", "head", "head", "base"):
        got = run(sides[side], args.checks)
        runs[side].append(got)
        for r in got:
            print(f"[turns] {side} {r['check']}: kernel_ms={r['ms']:.4f} "
                  f"plain_ms={r['plain_ms']:.4f} rel_l2={r['rel_l2']:.4e} "
                  f"faults={r['fault_rel_l2']}", flush=True)
    summary = {}
    for i, (name, dt) in enumerate(checks):
        per = {side: [rs[i] for rs in runs[side]] for side in runs}
        ms = {side: sum(r["ms"] for r in rs) / len(rs)
              for side, rs in per.items()}
        summary[f"{name}:{dt}"] = {
            "base_ms": ms["base"], "head_ms": ms["head"],
            "head_over_base": ms["head"] / ms["base"],
            "rel_l2": {s: rs[0]["rel_l2"] for s, rs in per.items()},
            "fault_rel_l2": {s: rs[0]["fault_rel_l2"] for s, rs in per.items()}}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
