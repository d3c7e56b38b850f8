"""The comparison's control: the plain reference put in the program's
place, each part one precision below what the configuration states
(``reference/precision.lowered``), and for a training cell the faults the
check has to catch.  Each is judged by the run's own comparison
(``harness.judge``, the cell's limits), and has to come out not correct.
The benchmark's own runs never run it; it sets the upper reading of each
limit (``PERF.md``).

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3

prints one JSON line per seed and control, with ``correct`` and each
number beside its limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from benchmark import harness


def control_lines(cell: str, seed: int, device: str, root=harness.BENCH,
                  overrides=None) -> list:
    """One judged line per control of ``cell`` at ``seed``."""
    overrides = overrides or {}
    wl = overrides.get("workload") or harness.load_json("workloads", cell,
                                                        root)
    cfg = overrides.get("config") or harness.load_json("configs",
                                                       wl["config"], root)
    mix = overrides.get("traffic") or harness.load_json("traffic",
                                                        wl["traffic"], root)
    entry = harness.load_module("entries", wl["entry"], root)
    r = harness.Run(cell, wl, cfg, mix, seed, 0.0, False, device,
                    time.perf_counter(), root)
    lines = []
    for kind, got in entry.control(r).items():
        limits = wl["check"]["limits"]
        r.checks = [(k, float(got[k]), float(limits[k])) for k in limits]
        correct, checks = harness.judge(r)
        lines.append({"workload": cell, "seed": int(seed), "control": kind,
                      "correct": correct, "checks": checks})
    return lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    harness.set_cache_env()
    for s in args.seeds.split(","):
        for line in control_lines(args.workload, int(s), args.device):
            print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
