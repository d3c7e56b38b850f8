#!/usr/bin/env python3
"""Phase 4's conversions of two checkouts on one card, in turns, with the
host time by phase.

    python3 tools/conversion_turns.py --base DIR [--reps 2]

Each side runs in a process of its own that builds its own kernels from
its own sources: it writes chip_smoke.py's random-weight config_44k
project (the same seeds), loads ``Svc`` in bf16 and in f32, converts the
first clip once to warm up, then converts chip_smoke.py's three clips
(6.5, 9 and 14 s) through ``infer_cli.run_clip`` ``--reps`` times.  Per
clip and dtype it reports the wall (host clock ending in a sync) and the
host seconds by the innermost of the program's spans open at each moment
(``chip_smoke.phase_sums``: ``cli.read``, ``cli.slice``, ``svc.mel``,
``svc.f0``, ``svc.units``, ``svc.sample``, ``svc.vocode``, ...; ``other``
outside every span); a checkout from before the spans reports the
seconds its ``Svc.timings`` gathered instead.  The sides run in the order
base, head, head, base; one JSON line at the end holds each side's runs.
Needs an NVIDIA GPU.
"""

from __future__ import annotations

import argparse
import functools
import json
import os
import subprocess
import sys
import tempfile
import time

HEAD = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "TURN "


def child(root: str, reps: int) -> int:
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs
    from diffsvc_tpu_torch import infer_cli
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    # a checkout from before the program's spans sums its Svc.timings
    old = not os.path.exists(os.path.join(root, "diffsvc_tpu_torch", "utils",
                                          "trace.py"))

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)            # Svc keeps its ./infer_tools caches here
        cfg_fn, ckpt = synth.write_project(
            os.path.join(tmp, "proj"),
            {"base_config": [os.path.join(root, "configs",
                                          "config_44k.yaml")]},
            cs.VOC_H, hubert_cfg=HubertConfig())
        wavs = []
        for i, (secs, f0, gaps) in enumerate(cs.CLIPS):
            fn = os.path.join(tmp, f"clip{i}.wav")
            save_wav(synth.voiced_wav(secs, 44100, f0, gaps, seed=i), fn,
                     44100)
            wavs.append(fn)
        for dt in ("bfloat16", ""):
            svc = Svc("proj", cfg_fn, True, ckpt, device="cuda")
            svc.hp["diff_compute_dtype"] = dt
            phases = functools.partial(cs.phase_sums, svc) if old \
                else cs.phase_sums

            def convert(fn):
                return infer_cli.run_clip(
                    svc, key=0, acc=cs.ACC, use_pe=False, use_crepe=False,
                    thre=0.05, use_gt_mel=False, add_noise_step=500,
                    file_path=fn, out_path=fn[:-4] + "_out.wav")

            convert(wavs[0])
            for _ in range(reps):
                for fn, (secs, _, _) in zip(wavs, cs.CLIPS):
                    torch.cuda.synchronize()
                    t0 = time.time()
                    with phases() as sums:
                        convert(fn)
                        torch.cuda.synchronize()
                    wall = time.time() - t0
                    print(MARK + json.dumps({
                        "dtype": dt or "float32", "secs": secs,
                        "wall_s": wall, "phases_s": sums}), flush=True)
            del svc
            torch.cuda.empty_cache()
    return 0


def run(root: str, reps: int) -> list:
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--child", root, "--reps", str(reps)],
                          capture_output=True, text=True, cwd=root)
    if proc.returncode != 0:
        raise SystemExit(f"conversion_turns: {root} failed "
                         f"({proc.returncode}):\n{proc.stderr[-4000:]}")
    return [json.loads(line[len(MARK):]) for line in proc.stdout.splitlines()
            if line.startswith(MARK)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--base", help="the other checkout's root")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--child", default="", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        return child(args.child, args.reps)
    if not args.base:
        ap.error("--base is required")
    sides = {"base": os.path.abspath(args.base), "head": HEAD}
    runs = {"base": [], "head": []}
    for side in ("base", "head", "head", "base"):
        for rec in run(sides[side], args.reps):
            print(f"[turns] {side} {rec['dtype']} {rec['secs']:.1f}s: wall="
                  f"{rec['wall_s']:.4f}s host time "
                  f"{ {k: round(v, 4) for k, v in rec['phases_s'].items()} }",
                  flush=True)
            runs[side].append(rec)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
