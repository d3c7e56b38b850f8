#!/usr/bin/env python3
"""Where K3's time goes: time diagnostic variants of its conv kernel on one
NVIDIA GPU, at the openvpi stage shapes of 5 s of 44.1 kHz audio.

    python3 tools/k3_variants.py

Each variant is ``diffsvc_tpu_torch/csrc/vocoder_tail.cu`` with one piece
of its main loop taken out, built by its own ``nvcc`` into
``build/k3_variants/<name>/`` and timed (CUDA events, 20 launches after a
warm-up) on the same inputs and launch plan as the kernel itself, at two
warpgroups (128 rows per CTA) and at one (64), beside one true-f32
``F.conv1d`` of the same shape.  Only ``cur`` computes the conv; the others
are wrong on purpose, and the difference of their times from ``cur`` is
what the piece they drop costs:

    cur            the kernel as it is
    hi_only        one TF32 product (a_hi b_hi) per k8 step instead of three
    b_lo_unloaded  the weights' lo tiles not copied into the ring
    no_refill      no weight block copied after the first two
    no_barrier     no barrier before each K block
    no_add         each K block's sum not added into the total
"""

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch                                          # noqa: E402
import torch.nn.functional as F                       # noqa: E402

from diffsvc_tpu_torch.ops.hopper import _build       # noqa: E402
from diffsvc_tpu_torch.ops.hopper import vocoder_tail as vt  # noqa: E402

SRC = os.path.join(_build.CSRC, "vocoder_tail.cu")
OUT = os.path.join(ROOT, "build", "k3_variants")
MMA3 = """      mma_rs(blk, lo[s], desc(st + o), s > 0);
      mma_rs(blk, hi[s], desc(st + BN * BK * 4 + o), 1);
      mma_rs(blk, hi[s], desc(st + o), 1);
"""
LOAD_LO = ("    cp_async16(slot + BN * BK * 4 + swz(r, ch), src + g.plane, "
           "true);\n")
REFILL = ("    if (nxt < nk) load_b<BN>(w, g, nxt, ring + (nxt % STAGES) * "
          "SLOT);\n")
BARRIER = "    fence_proxy_async();\n    __syncthreads();\n    const int nxt"
ADD = "    for (int i = 0; i < BN / 2; ++i) acc[i] += blk[i];\n"
# (C, T, k, d) of one conv at each stage's widest and narrowest halo
CASES = [(128, 27584, 11, 5), (128, 27584, 3, 1), (64, 55168, 11, 1),
         (16, 220672, 11, 5), (16, 220672, 3, 1)]


def variants(src: str) -> dict:
    for piece in (MMA3, LOAD_LO, REFILL, BARRIER, ADD):
        if piece not in src:
            raise SystemExit(f"k3_variants: the kernel's main loop changed; "
                             f"update this script (missing {piece!r})")
    return {
        "cur": src,
        "hi_only": src.replace(
            MMA3, "      mma_rs(blk, hi[s], desc(st + o), s > 0);\n"),
        "b_lo_unloaded": src.replace(LOAD_LO, ""),
        "no_refill": src.replace(REFILL, ""),
        "no_barrier": src.replace(
            BARRIER, "    fence_proxy_async();\n    const int nxt"),
        "no_add": src.replace(
            ADD, "    for (int i = 0; i < BN / 2; ++i) acc[i] = blk[i];\n"),
    }


def build(srcs: dict) -> dict:
    """One nvcc per variant, started together; {name: loaded library}."""
    procs = {}
    for name, src in srcs.items():
        d = os.path.join(OUT, name)
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "vocoder_tail.cu"), "w") as f:
            f.write(src)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
             "-shared", "-o", os.path.join(d, "lib.so"),
             os.path.join(d, "vocoder_tail.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"k3_variants: nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(os.path.join(OUT, name, "lib.so"))
        lib.dsvc_tail_conv.argtypes = _build.SIGNATURES["dsvc_tail_conv"]
        lib.dsvc_tail_conv.restype = ctypes.c_int
        libs[name] = lib
    return libs


def timed(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def one_warpgroup(p: vt.TilePlan, t: int) -> vt.TilePlan:
    win = vt.WG_ROWS + p.win_rows - p.bm
    return p._replace(bm=vt.WG_ROWS, threads=128, win_rows=win,
                      smem=p.smem - (p.win_rows - win) * p.lda * 4,
                      grid_m=-(-t // vt.WG_ROWS))


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_variants: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"[k3_variants] {card}")
    with open(SRC) as f:
        libs = build(variants(f.read()))
    dev, stream = torch.device("cuda"), torch.cuda.current_stream()
    g = torch.Generator().manual_seed(0)
    for c, t, k, d in CASES:
        conv = torch.nn.Conv1d(c, c, k, dilation=d, padding=(k - 1) * d // 2)
        cp = vt.conv_plan(conv.to(dev), d, (k - 1) * d // 2)
        x = torch.randn(1, t, c, generator=g).to(dev)
        xc = F.leaky_relu(x, 0.1).transpose(1, 2).contiguous()
        ref = F.conv1d(xc, cp.w_t, cp.b, padding=cp.pad,
                       dilation=d).transpose(1, 2)
        lib_ms = timed(lambda: F.conv1d(xc, cp.w_t, cp.b, padding=cp.pad,
                                        dilation=d))
        plan = vt.conv_tile_plan(x.shape, cp)
        plans = {"128 rows": plan, "64 rows": one_warpgroup(plan, t)}
        gflop = 2.0 * t * c * c * k / 1e9
        for name, lib in libs.items():
            for rows, p in plans.items():
                out = torch.empty(1, t, c, device=dev)
                arr = p.c_array()

                def run():
                    err = lib.dsvc_tail_conv(
                        x.data_ptr(), cp.wp.data_ptr(), cp.b.data_ptr(),
                        out.data_ptr(), None, None, 0, 0.0, 1, t, c, c, 0.1,
                        0, arr, stream.cuda_stream)
                    if err:
                        raise RuntimeError(f"{name}: CUDA error {err}")

                ms = timed(run)
                rel = float((out - ref).double().norm()
                            / ref.double().norm())
                print(f"[k3_variants] C={c} T={t} k={k} d={d} {name} "
                      f"{rows}: {ms:.4f} ms ({3 * gflop / ms / 495:.1%} of "
                      f"495 TFLOP/s at 3xTF32; rel_l2 {rel:.2e}); F.conv1d "
                      f"true f32 {lib_ms:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
