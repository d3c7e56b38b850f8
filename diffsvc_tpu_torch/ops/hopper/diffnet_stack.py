"""K1: the DiffNet residual stack — hand-written Hopper kernels + plain twin.

Replaces ``diffsvc_tpu/ops/pallas/diffnet_stack.py:residual_stack`` (Pallas
kernel ``_kernel``): the L gated residual layers of one denoiser evaluation,
returning the f32 skip sum.  CUDA source: ``csrc/diffnet_stack.cu``.

What bounds it on the H100: arithmetic.  At T=1024, C=384, L=20 one call is
48.3 GFLOP against ~31 MB of bf16 weights and conditioner, far above the
card's FLOP-per-byte line.  Both dtypes run on the tensor cores, two wgmma
layer kernels per layer over weights this wrapper packs K-major with each N
tile pairing 32 gate and filter (or residual and skip) columns, and a
staged y = x + sb that the gate kernel reads as plain tiles at rows t-d, t,
t+d.  The launch plan (tiles, stages, shared memory, grid, channel padding)
is ``tc_plan``.
- bf16 (the TPU kernel's only dtype; serving's production mode): bf16
  operands, f32 sums (``csrc/diffnet_layer_tc.cuh``).
- f32 (the default config's dtype; no TPU counterpart, JAX samples f32
  through the XLA scan): 3xTF32 split products that keep f32 accuracy
  (``csrc/diffnet_layer_tf32x3.cuh``).  Every f32 operand is split as
  a = hi + lo (``split_tf32``): the weights here, once per call, into a hi
  and a lo plane each; the activations y and h by the kernel that writes
  them.  Each product is a_lo b_hi + a_hi b_lo + a_hi b_hi
  (``matmul_tf32x3``), good to ~2^-21 relative, where plain TF32 would give
  ~2^-11.

Differences from the TPU kernel: takes [B, T, C] directly (the TPU kernel is
B=1 and is vmapped), any T and C, and f32 as well as bf16 operands.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build

launches = 0      # stacks launched on a CUDA tensor (each call, and each
                  # evaluation of a ladder, plms_ladder.py)
launches_tc = 0   # of those, the bf16 ones on the tensor-core kernels
launches_tf32x3 = 0   # of those, the f32 ones on the 3xTF32 kernels

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# The tensor-core kernels' tiles (csrc/diffnet_layer_tc.cuh, namespace tc):
# 64 rows (one wgmma M) x 64 columns (one wgmma N; 32 channels' gate and
# filter columns in K1) x 64 deep (one 128-byte swizzled row of bf16), a
# 4-stage cp.async ring, one warpgroup.
TC_BM, TC_BN, TC_BK, TC_STAGES, TC_THREADS = 64, 64, 64, 4, 128
TC_HALF = TC_BN // 2
TC_TILE_BYTES = TC_BM * TC_BK * 2
# The f32 (3xTF32) kernels' tiles (csrc/diffnet_layer_tf32x3.cuh, namespace
# tf32x3): the same 64 x 64 CTA tile, 32 deep (one 128-byte swizzled row of
# f32); a stage holds four tiles (A hi, A lo, B hi, B lo), a 3-stage ring.
X3_BK, X3_STAGES = 32, 3
X3_TILE_BYTES = TC_BM * X3_BK * 4
TC_ALIGN = 1024            # the 128-byte swizzle repeats every 1 KB
SMEM_MAX = 232448          # shared memory a block can use on the H100
# the order csrc/diffnet_layer_tc.cuh reads the plan in (enum P_*)
PLAN_FIELDS = ("cp", "mp", "bm", "bn", "bk", "stages", "threads", "grid_m",
               "grid_n_layer", "grid_n_in", "smem_layer", "smem_in",
               "smem_epi")


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


@dataclass(frozen=True)
class TcPlan:
    """Launch plan of the tensor-core kernels for [B, T, C] (and the
    ladder's M mel bins; m = 0 for K1 alone).  Channels are padded to cp
    (and mp) inside the kernels' buffers and packed weights; rows are tiled
    per sample, the ragged T edge masked in the kernels.  The layer kernels
    run on grid (grid_m, grid_n_layer, B) and the ladder's input projection
    on (grid_m, grid_n_in, B).  bf16: the ladder's epilogue on (grid_m, 1,
    B); f32: its skip projection on (grid_m, grid_n_in, B), then its output
    projection and update on (grid_m, mp / bn, B), both in smem_epi."""
    batch: int
    cp: int
    mp: int
    bm: int
    bn: int
    bk: int
    stages: int
    threads: int
    grid_m: int
    grid_n_layer: int
    grid_n_in: int
    smem_layer: int
    smem_in: int
    smem_epi: int

    def c_array(self):
        """The plan as the C side reads it (``const int*``)."""
        return (ctypes.c_int * len(PLAN_FIELDS))(
            *(getattr(self, f) for f in PLAN_FIELDS))

    @property
    def ctas_layer(self) -> int:
        """CTAs per layer-kernel launch."""
        return self.batch * self.grid_m * self.grid_n_layer


def tc_plan(b: int, t: int, c: int, m: int = 0,
            dtype=torch.bfloat16) -> TcPlan:
    """The plan for K1 at [b, t, c] (m = 0), or for K2 with m mel bins, on
    the bf16 kernels or, for ``torch.float32``, the 3xTF32 ones."""
    cp = _round_up(c, TC_BN)
    mp = _round_up(m, TC_BN) if m else 0
    if dtype == torch.float32:
        tile = X3_TILE_BYTES
        ring = X3_STAGES * 4 * tile + TC_ALIGN
        return TcPlan(
            batch=b, cp=cp, mp=mp, bm=TC_BM, bn=TC_BN, bk=X3_BK,
            stages=X3_STAGES, threads=TC_THREADS, grid_m=-(-t // TC_BM),
            grid_n_layer=cp // TC_HALF, grid_n_in=cp // TC_BN if m else 0,
            smem_layer=ring,
            smem_in=4 * (mp // X3_BK) * tile + TC_ALIGN if m else 0,
            smem_epi=ring if m else 0)
    tiles = TC_TILE_BYTES
    return TcPlan(
        batch=b, cp=cp, mp=mp, bm=TC_BM, bn=TC_BN, bk=TC_BK,
        stages=TC_STAGES, threads=TC_THREADS, grid_m=-(-t // TC_BM),
        grid_n_layer=cp // TC_HALF, grid_n_in=cp // TC_BN if m else 0,
        smem_layer=TC_STAGES * 2 * tiles + TC_ALIGN,
        smem_in=2 * (mp // TC_BK) * tiles + TC_ALIGN if m else 0,
        smem_epi=(2 * (cp // TC_BK) + TC_STAGES) * tiles + TC_ALIGN if m
        else 0)


def pack_paired(w, cp: int):
    """[L, taps, C, 2C] (K x N per tap) -> [L, 2cp, taps cp] K-major, zero
    padded: row 64 i + 32 h + j of a layer is its column h C + 32 i + j
    (gate or residual half h = 0, filter or skip half h = 1; zero where
    32 i + j >= C), and column tap cp + c is input channel c of that tap
    (zero past C)."""
    n_layers, taps, c, _ = w.shape
    halves = [F.pad(w[..., i * c:(i + 1) * c], (0, cp - c, 0, cp - c))
              for i in (0, 1)]                         # [L, taps, cp(k), cp(n)]
    p = torch.stack(halves, 3).view(n_layers, taps, cp, 2, cp // TC_HALF,
                                    TC_HALF)
    return p.permute(0, 4, 3, 5, 1, 2).reshape(n_layers, 2 * cp,
                                               taps * cp).contiguous()


def pack_kmajor(w, kp: int, np_: int):
    """[K, N] -> [np_, kp]: transposed to K-major, zero padded."""
    k, n = w.shape
    return F.pad(w.t(), (0, kp - k, 0, np_ - n)).contiguous()


def _round_tf32(v):
    """v rounded to the nearest TF32 value (10 explicit mantissa bits, ties
    away from zero, as ``cvt.rna.tf32.f32``), kept as f32 with its 13 low
    bits zero: half a TF32 ulp added to the bit pattern, then truncated."""
    return ((v.contiguous().view(torch.int32) + 0x1000) & -0x2000).view(
        torch.float32)


def split_tf32(a):
    """(hi, lo) with hi = tf32(a) and lo = tf32(a - hi), both f32 tensors
    whose 13 low mantissa bits are zero: what the 3xTF32 kernels multiply.
    a - hi is exact in f32, so for finite normal a the remainder a - hi - lo
    is at most 2^-22 |a|; subnormals are rounded at the same bit position,
    so theirs is at most 2^-137.  Signs and zeros carry through (hi and lo
    of -0 are -0 and 0)."""
    hi = _round_tf32(a)
    return hi, _round_tf32(a - hi)


def pack_split(p):
    """[..., N, K] f32 -> [..., 2, N, K]: the hi and lo planes of
    ``split_tf32``, as the 3xTF32 kernels read packed weights."""
    return torch.stack(split_tf32(p), -3).contiguous()


def matmul_tf32x3(a, b):
    """a @ b with the 3xTF32 kernels' products, in plain PyTorch: both
    operands split by ``split_tf32``, then a_lo b_hi + a_hi b_lo + a_hi b_hi
    (the small products first, as the kernels add them), sums in f32.  The
    tests run the plain versions with it to hold the kernels' arithmetic
    against the JAX package's f32."""
    a_hi, a_lo = split_tf32(a)
    b_hi, b_lo = split_tf32(b)
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def pack_layers(wd, wo, cp: int):
    """K1's layer weights as the tensor-core kernels read them: wd [L, 3, C,
    2C] -> [L, 2cp, 3cp] and wo [L, C, 2C] -> [L, 2cp, cp] (``pack_paired``);
    at f32 each split into hi and lo planes, [L, 2, 2cp, 3cp] and [L, 2,
    2cp, cp]."""
    wd, wo = pack_paired(wd, cp), pack_paired(wo[:, None], cp)
    if wd.dtype == torch.float32:
        wd, wo = pack_split(wd), pack_split(wo)
    return wd, wo


def layer_scratch(b: int, t: int, cp: int, dtype, device):
    """(y, h): the staged y = x + sb and the gated h, with zero pad
    channels: [B, T, cp] at bf16; at f32 a hi and a lo plane each, [2, B, T,
    cp]."""
    shape = (b, t, cp) if dtype == torch.bfloat16 else (2, b, t, cp)
    y = torch.zeros(shape, dtype=dtype, device=device)
    return y, torch.zeros_like(y)


def residual_stack_plain(x0, sb, cond_proj, wd, bd, wo, bo, *, cycle: int,
                         matmul=torch.matmul):
    """Plain PyTorch version with the kernel's rounding points: matmul
    operands in the compute dtype, products summed in f32, running x
    rounded to the compute dtype after every layer, skip in f32.  ``matmul``
    computes the products (``matmul_tf32x3``: the f32 kernels' arithmetic)."""
    dt = x0.dtype
    n_layers, b, t, c2 = cond_proj.shape
    c = c2 // 2
    x = x0
    skip = torch.zeros(b, t, c, dtype=torch.float32, device=x0.device)
    for layer in range(n_layers):
        d = 2 ** (layer % cycle)
        y = (x.float() + sb[layer][:, None, :].float()).to(dt).float()
        yl = F.pad(y, (0, 0, d, 0))[:, :t]           # y[t-d], zero outside
        yr = F.pad(y, (0, 0, 0, d))[:, d:d + t]      # y[t+d], zero outside
        w = wd[layer].float()
        z = matmul(yl, w[0]) + matmul(y, w[1]) + matmul(yr, w[2])
        z = z + bd[layer].float() + cond_proj[layer].float()
        h = (torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])).to(dt)
        o = matmul(h.float(), wo[layer].float()) + bo[layer].float()
        x = ((x.float() + o[..., :c]) * (1.0 / math.sqrt(2.0))).to(dt)
        skip = skip + o[..., c:]
    return skip


def _check(x0, sb, cond_proj, wd, bd, wo, bo):
    if x0.dtype not in _DTYPES:
        raise TypeError(f"residual_stack: unsupported dtype {x0.dtype}")
    b, t, c = x0.shape
    n_layers = cond_proj.shape[0]
    shapes = {"cond_proj": (cond_proj, (n_layers, b, t, 2 * c)),
              "wd": (wd, (n_layers, 3, c, 2 * c)), "bd": (bd, (n_layers, 2 * c)),
              "wo": (wo, (n_layers, c, 2 * c)), "bo": (bo, (n_layers, 2 * c))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"residual_stack: {name} {tuple(a.shape)} != {shape}")
        if not a.is_contiguous():
            raise ValueError(f"residual_stack: {name} must be contiguous")
    if tuple(sb.shape) != (n_layers, b, c) or sb.stride(2) != 1:
        raise ValueError(f"residual_stack: sb {tuple(sb.shape)} must be "
                         f"[{n_layers},{b},{c}] with unit channel stride")
    for name, a in (("x0", x0), ("sb", sb), *((k, v[0]) for k, v in shapes.items())):
        if a.device != x0.device or a.dtype != x0.dtype:
            raise ValueError(f"residual_stack: {name} is {a.dtype} on "
                             f"{a.device}, expected {x0.dtype} on {x0.device}"
                             " (a state in another dtype than the operands "
                             "goes through diffnet_stack_train)")
    if not x0.is_contiguous():
        raise ValueError("residual_stack: x0 must be contiguous")


def residual_stack(x0, sb, cond_proj, wd, bd, wo, bo, *, cycle: int):
    """Run the full residual stack.

    :param x0:        [B, T, C] activations after input projection + relu
    :param sb:        [L, B, C] per-layer step bias (step MLP and each
                      layer's diffusion_projection); a batch stride of 0
                      (an expanded view) is accepted
    :param cond_proj: [L, B, T, 2C] hoisted conditioner projections
    :param wd/bd:     [L, 3, C, 2C] / [L, 2C] dilated-conv taps (t-d, t, t+d)
    :param wo/bo:     [L, C, 2C] / [L, 2C] output 1x1
    :returns:         [B, T, C] float32 skip sum (caller scales by 1/sqrt(L))

    All operands share x0's dtype (float32 or bfloat16) and device.  CPU
    tensors take the plain version; CUDA tensors launch the tensor-core
    kernels (bf16 operands, or f32 as 3xTF32 split products).
    """
    global launches, launches_tc, launches_tf32x3
    _check(x0, sb, cond_proj, wd, bd, wo, bo)
    if x0.device.type == "cpu":
        return residual_stack_plain(x0, sb, cond_proj, wd, bd, wo, bo,
                                    cycle=cycle)
    if x0.device.type != "cuda":
        raise ValueError(f"residual_stack: unsupported device {x0.device}")
    b, t, c = x0.shape
    plan = tc_plan(b, t, c, dtype=x0.dtype)
    x = x0.clone()                                  # running state, in place
    skip = torch.empty(b, t, c, dtype=torch.float32, device=x0.device)
    y, h = layer_scratch(b, t, plan.cp, x0.dtype, x0.device)
    wd, wo = pack_layers(wd, wo, plan.cp)
    lib = _build.lib()
    err = lib.dsvc_residual_stack(
        _DTYPES[x0.dtype], x.data_ptr(), h.data_ptr(), skip.data_ptr(),
        sb.data_ptr(), sb.stride(0), sb.stride(1), cond_proj.data_ptr(),
        wd.data_ptr(), bd.data_ptr(), wo.data_ptr(), bo.data_ptr(),
        b, t, c, cond_proj.shape[0], cycle, y.data_ptr(), plan.c_array(),
        _build.stream())
    _build.check(err, "dsvc_residual_stack")
    launches += 1
    launches_tc += x0.dtype == torch.bfloat16
    launches_tf32x3 += x0.dtype == torch.float32
    return skip
