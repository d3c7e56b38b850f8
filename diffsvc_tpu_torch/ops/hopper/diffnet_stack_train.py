"""K4: the DiffNet residual stack for training — hand-written Hopper kernels
(forward with save, batch-fused backward) + their plain PyTorch versions.

Replaces ``diffsvc_tpu/ops/pallas/diffnet_stack.py:residual_stack_train_batched``
(forward ``_fwd_kernel`` via ``_call_fwd``, backward ``_bwd_kernel_b`` via
``_call_bwd_batched``, custom VJP ``_rstb_fwd``/``_rstb_bwd``).  CUDA source:
``csrc/diffnet_stack_train.cu`` (+ K1's tensor-core layer kernels of
``csrc/diffnet_layer_tc.cuh`` and ``csrc/diffnet_layer_tf32x3.cuh`` for the
forward, and the backward of ``csrc/diffnet_train_bwd.cuh``, shared with
K5).  The forward with save is also K5's forward
(``diffnet_stack_per_sample``), as ``_call_fwd`` serves both JAX routes.

- Forward: K1's layer math with the residual state x in x0's dtype (f32 in
  training) and every matmul operand in the *stream* dtype (``wd.dtype``:
  bf16 or f32); each layer's input x_l is saved, rounded to the stream
  dtype, into ``xsave`` [L, B, T, C].
- Backward: layers in reverse; z and the gates are recomputed from the
  saved x_l; ``do``, ``dz`` and ``h`` are rounded to the stream dtype before
  the products; weight and bias grads are summed over the whole batch in
  f32; the dx carry is f32 and comes back as dx0.  Every reduction sums in
  a fixed order (no atomics), so a step repeats bit for bit.

What bounds it on the H100: tensor-core operations (4.35 TFLOP per step at
B=24, T=1024, C=384, L=20).  Both streams run every product on wgmma: bf16
operands at the bf16 stream, 3xTF32 split products (``matmul_tf32x3``) at
the f32 stream, which keep its f32 accuracy.  The backward's weight grads
contract over rows, and tf32 wgmma reads its operands K-major only, so the
backward also writes h, do, dz and y's taps transposed, into positions
where every weight-grad chunk is padded to whole K blocks
(``train_plan``, ``chunk_positions``); the transposed weights are packed
once per call (``pack_bwd``).

Layout differences from the TPU kernel: ``xsave`` is layer-major
[L, B, T, C] (the TPU's is [B, L, T, C]), so each layer's slice is one
contiguous block; any T and C.
"""

from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from . import _build
from .diffnet_stack import (_DTYPES, TC_ALIGN, TC_BK, TC_BN, TC_STAGES,
                            TC_THREADS, X3_STAGES, layer_scratch, pack_layers,
                            pack_paired, pack_split, residual_stack, tc_plan)

launches = 0       # kernel launches (forward and backward calls on CUDA tensors)
bwd_launches = 0   # of which batch-fused backward calls
bwd_launches_f32 = 0   # of which at the f32 stream (3xTF32 products)

RCH = 2048     # rows per partial sum of the weight-grad contractions
CCH = 128      # rows per partial sum of the bias / step-bias column sums
KC_ALIGN = 64  # weight-grad chunks padded to whole K blocks of both modes
TRAIN_TILE = 8192   # bytes of one operand tile: 64 rows of 128 bytes
WG_WGS, WG_NB = 2, 128   # the weight grads' CTA: two warpgroups, 128 x 128
# the order csrc/diffnet_train_bwd.cuh reads the plan in (enum Q_*)
TRAIN_PLAN_FIELDS = ("mode", "cp", "bk", "stages", "threads", "smem",
                     "smem_w", "kc", "rp", "nchunk", "cps", "grid_t",
                     "grid_r", "grid_c", "grid_pair", "grid_wo", "grid_wd",
                     "grid_wn")
_INV_SQRT2 = 1.0 / math.sqrt(2.0)
_PAIRS = {(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
          (torch.bfloat16, torch.bfloat16)}   # (state, stream) dtypes


@dataclass(frozen=True)
class TrainPlan:
    """Launch plan of the training backward's tensor-core kernels for
    [B, T, C] with weight-grad segments of ``seg_rows`` rows (K4: B*T; K5:
    T), each cut into ``cps`` chunks of at most ``RCH`` rows that start at
    the segment's first row.  Channels are padded to cp.  Row-tiled products
    (64 x 64 CTA tiles, one warpgroup, ``smem`` bytes of ring) run on
    (grid_t, grid_c, B) (dy), (grid_t, grid_pair, B) (the gate recompute,
    paired gate/filter tiles) or (grid_r, grid_c) (dh); the weight grads
    (128 x 128, two warpgroups, ``smem_w``) on (grid_wo, grid_wn, nchunk)
    (dWo) and (grid_wd, grid_wn, nchunk) (dW_j).  The transposed operand
    planes hold rp = nchunk * kc positions: chunk k's rows at [k kc, k kc +
    its rows), zeros after."""
    mode: int
    cp: int
    bk: int
    stages: int
    threads: int
    smem: int
    smem_w: int
    kc: int
    rp: int
    nchunk: int
    cps: int
    grid_t: int
    grid_r: int
    grid_c: int
    grid_pair: int
    grid_wo: int
    grid_wd: int
    grid_wn: int

    def c_array(self):
        """The plan as the C side reads it (``const int*``)."""
        return (ctypes.c_int * len(TRAIN_PLAN_FIELDS))(
            *(getattr(self, f) for f in TRAIN_PLAN_FIELDS))

    @property
    def planes(self) -> int:
        """Planes per operand: 2 (hi, lo) at f32, 1 at bf16."""
        return 2 if self.mode == _DTYPES[torch.float32] else 1


def train_plan(b: int, t: int, c: int, seg_rows: int, dtype) -> TrainPlan:
    """The backward's plan at [b, t, c] with segments of ``seg_rows`` rows,
    on the bf16 kernels or, for ``torch.float32``, the 3xTF32 ones."""
    rows = b * t
    if seg_rows <= 0 or rows % seg_rows:
        raise ValueError(f"train_plan: {seg_rows} rows per segment do not "
                         f"divide {rows}")
    cp = -(-c // TC_BN) * TC_BN
    cps = -(-seg_rows // RCH)
    kc = -(-min(RCH, seg_rows) // KC_ALIGN) * KC_ALIGN
    nchunk = rows // seg_rows * cps
    f32 = dtype == torch.float32
    planes, stages = (2, X3_STAGES) if f32 else (1, TC_STAGES)
    wm = WG_WGS * 64
    return TrainPlan(
        mode=_DTYPES[dtype], cp=cp, bk=32 if f32 else TC_BK, stages=stages,
        threads=TC_THREADS, smem=stages * 2 * planes * TRAIN_TILE + TC_ALIGN,
        smem_w=stages * planes * (WG_WGS * TRAIN_TILE + WG_NB * 128)
        + TC_ALIGN, kc=kc, rp=nchunk * kc, nchunk=nchunk, cps=cps,
        grid_t=-(-t // 64), grid_r=-(-rows // 64), grid_c=cp // 64,
        grid_pair=cp // 32, grid_wo=-(-cp // wm), grid_wd=-(-3 * cp // wm),
        grid_wn=-(-2 * cp // WG_NB))


def chunk_positions(b: int, t: int, seg_rows: int, kc: int, device=None):
    """[B*T] int64: the position of each row in the transposed planes,
    as ``pos_of`` (``csrc/diffnet_train_bwd.cuh``) computes it."""
    r = torch.arange(b * t, device=device)
    seg, within = r // seg_rows, r % seg_rows
    k = within // RCH
    return (seg * -(-seg_rows // RCH) + k) * kc + within - k * RCH


def pack_dh(wo, cp: int):
    """wo [L, C, 2C] -> [L, cp, 2cp], dh's B (dh = do wo^T): row c holds wo's
    row c with each half of its 2C columns padded to cp (the layout of the
    do operand); zero past C."""
    n_layers, c, _ = wo.shape
    w = F.pad(wo.view(n_layers, c, 2, c), (0, cp - c, 0, 0, 0, cp - c))
    return w.reshape(n_layers, cp, 2 * cp).contiguous()


def pack_dy(wd, cp: int):
    """wd [L, 3, C, 2C] -> [L, cp, 6cp], dy's B (dy = sum_j dz_j W_j^T): row
    c holds tap j's row c at columns j 2cp + h cp + k (column h C + k of
    W_j); zero past C."""
    n_layers, taps, c, _ = wd.shape
    w = F.pad(wd.view(n_layers, taps, c, 2, c), (0, cp - c, 0, 0, 0, cp - c))
    return w.permute(0, 2, 1, 3, 4).reshape(n_layers, cp,
                                            taps * 2 * cp).contiguous()


def pack_bwd(wd, wo, cp: int):
    """The backward's weights as its kernels read them, K-major: the gate
    recompute's wd (K1's ``pack_paired``, [L, 2cp, 3cp]), ``pack_dh(wo)``
    and ``pack_dy(wd)``; at f32 each split into hi and lo planes
    (``pack_split``: [L, 2, ...])."""
    out = (pack_paired(wd, cp), pack_dh(wo, cp), pack_dy(wd, cp))
    if wd.dtype == torch.float32:
        out = tuple(pack_split(w) for w in out)
    return out


def stream_dtype(name: str, state_dtype: torch.dtype) -> torch.dtype:
    """``diffnet_train_stream_dtype`` -> torch dtype: "bf16" streams bf16,
    anything else streams in the state's own dtype (the JAX ``_sd``)."""
    return torch.bfloat16 if name == "bf16" else state_dtype


def _shift(y, s: int):
    """out[:, t] = y[:, t - s], zero where t - s falls outside [0, T)."""
    t = y.shape[1]
    if s >= 0:
        return F.pad(y, (0, 0, s, 0))[:, :t]
    return F.pad(y, (0, 0, 0, -s))[:, -s:t - s]


def _taps(x, sb_l, d: int, sd):
    """(y[t-d], y[t], y[t+d]) in f32 with values rounded to ``sd``;
    y = x + sb_l."""
    y = (x.float() + sb_l[:, None, :].float()).to(sd).float()
    return _shift(y, d), y, _shift(y, -d)


def residual_stack_train_fwd_plain(x0, sb, cond_proj, wd, bd, wo, bo, *,
                                   cycle: int, matmul=torch.matmul):
    """Plain version of the forward with the TPU kernel's rounding points
    (``_fwd_kernel``): x in x0's dtype, y/h rounded to the stream dtype
    (``wd.dtype``), z and o in f32, skip summed in f32.  Returns (skip
    [B,T,C] f32, xsave [L,B,T,C] in the stream dtype).  ``matmul`` computes
    the products (``matmul_tf32x3``: the f32 stream's kernel arithmetic)."""
    sd = wd.dtype
    n_layers, b, t, c2 = cond_proj.shape
    c = c2 // 2
    x = x0
    skip = torch.zeros(b, t, c, dtype=torch.float32, device=x0.device)
    xsave = torch.empty(n_layers, b, t, c, dtype=sd, device=x0.device)
    for layer in range(n_layers):
        d = 2 ** (layer % cycle)
        xsave[layer] = x.to(sd)
        yl, y, yr = _taps(x, sb[layer], d, sd)
        w = wd[layer].float()
        z = matmul(yl, w[0]) + matmul(y, w[1]) + matmul(yr, w[2])
        z = z + bd[layer].float() + cond_proj[layer].float()
        h = (torch.sigmoid(z[..., :c]) * torch.tanh(z[..., c:])).to(sd)
        o = matmul(h.float(), wo[layer].float()) + bo[layer].float()
        x = ((x.float() + o[..., :c]) * _INV_SQRT2).to(x0.dtype)
        skip = skip + o[..., c:]
    return skip, xsave


def bwd_plain(xsave, sb, cond_proj, wd, bd, wo, dout, *, cycle: int,
              dcp_dtype, matmul=torch.matmul):
    """The explicit backward's math (``_bwd_kernel_b``, ``_bwd_kernel``),
    not autograd: y is recomputed from the saved, rounded x_l; do, dz and h
    are rounded to the stream dtype (``wd.dtype``) before the products; dcp
    is stored in ``dcp_dtype``.  Returns dx0 [B,T,C] f32, dsb [L,B,C] f32,
    dcp [L,B,T,2C] and dwd/dbd/dwo/dbo summed over the given batch in f32.
    ``matmul`` computes the products, as in the forward."""
    sd = wd.dtype
    n_layers, b, t, c2 = cond_proj.shape
    c = c2 // 2
    dev = xsave.device
    f32 = dict(dtype=torch.float32, device=dev)
    dx = torch.zeros(b, t, c, **f32)
    dsb = torch.empty(n_layers, b, c, **f32)
    dcp = torch.empty(n_layers, b, t, c2, dtype=dcp_dtype, device=dev)
    dwd = torch.empty(n_layers, 3, c, c2, **f32)
    dbd = torch.empty(n_layers, c2, **f32)
    dwo = torch.empty(n_layers, c, c2, **f32)
    dbo = torch.empty(n_layers, c2, **f32)
    for layer in reversed(range(n_layers)):
        d = 2 ** (layer % cycle)
        taps = _taps(xsave[layer], sb[layer], d, sd)
        w = wd[layer].float()
        z = matmul(taps[0], w[0]) + matmul(taps[1], w[1]) + matmul(taps[2],
                                                                   w[2])
        z = z + bd[layer].float() + cond_proj[layer].float()
        s = torch.sigmoid(z[..., :c])
        tf = torch.tanh(z[..., c:])
        h = (s * tf).to(sd).float()
        do = torch.cat([dx * _INV_SQRT2, dout.float()], dim=-1)
        do_c = do.to(sd).float()
        dwo[layer] = matmul(h.reshape(-1, c).T, do_c.reshape(-1, c2))
        dbo[layer] = do.sum((0, 1))
        dh = matmul(do_c, wo[layer].float().T)
        dz = torch.cat([dh * s * (1.0 - s) * tf, dh * s * (1.0 - tf * tf)],
                       dim=-1)
        dcp[layer] = dz.to(dcp_dtype)
        dbd[layer] = dz.sum((0, 1))
        dz_c = dz.to(sd).float()
        for j in range(3):
            dwd[layer, j] = matmul(taps[j].reshape(-1, c).T,
                                   dz_c.reshape(-1, c2))
        dy = (matmul(_shift(dz_c, -d), w[0].T) + matmul(dz_c, w[1].T)
              + matmul(_shift(dz_c, d), w[2].T))
        dsb[layer] = dy.sum(1)
        dx = dy + dx * _INV_SQRT2
    return dx, dsb, dcp, dwd, dbd, dwo, dbo


def residual_stack_train_batched_bwd_plain(xsave, sb, cond_proj, wd, bd, wo,
                                           dout, *, cycle: int,
                                           matmul=torch.matmul):
    """Plain version of the batch-fused backward: :func:`bwd_plain` with
    ``dout`` [B,T,C] and dcp in the stream dtype."""
    return bwd_plain(xsave, sb, cond_proj, wd, bd, wo, dout, cycle=cycle,
                     dcp_dtype=wd.dtype, matmul=matmul)


def _check(x0, sb, cond_proj, wd, bd, wo, bo):
    sd = wd.dtype
    if (x0.dtype, sd) not in _PAIRS:
        raise TypeError(f"residual_stack_train: state {x0.dtype} with stream "
                        f"{sd} is not supported")
    b, t, c = x0.shape
    n_layers = cond_proj.shape[0]
    shapes = {"cond_proj": (cond_proj, (n_layers, b, t, 2 * c)),
              "wd": (wd, (n_layers, 3, c, 2 * c)), "bd": (bd, (n_layers, 2 * c)),
              "wo": (wo, (n_layers, c, 2 * c)), "bo": (bo, (n_layers, 2 * c)),
              "sb": (sb, (n_layers, b, c))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape:
            raise ValueError(f"residual_stack_train: {name} "
                             f"{tuple(a.shape)} != {shape}")
        if a.device != x0.device:
            raise ValueError(f"residual_stack_train: {name} is on {a.device}, "
                             f"x0 on {x0.device}")
    for name, a in (("x0", x0), ("cond_proj", cond_proj), ("wd", wd),
                    ("wo", wo)):
        if not a.is_contiguous():
            raise ValueError(f"residual_stack_train: {name} must be contiguous")
    for name, a in (("cond_proj", cond_proj), ("wo", wo)):
        if a.dtype != sd:
            raise ValueError(f"residual_stack_train: {name} is {a.dtype}, "
                             f"the stream dtype (wd) is {sd}")
    for name, a in (("sb", sb), ("bd", bd), ("bo", bo)):
        if not a.is_floating_point():
            raise ValueError(f"residual_stack_train: {name} must be floating")


def on_card(x0, what: str) -> bool:
    """True for CUDA (launch), False for CPU (plain version); raises on any
    other device."""
    if x0.device.type == "cpu":
        return False
    if x0.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x0.device}")
    return True


def residual_stack_train_fwd(x0, sb, cond_proj, wd, bd, wo, bo, *,
                             cycle: int):
    """Forward with save: (skip [B,T,C] f32, xsave [L,B,T,C]).

    :param x0: [B, T, C] state (f32, or bf16 with a bf16 stream)
    :param sb: [L, B, C] step bias; bd / bo [L, 2C] biases (any float dtype)
    :param cond_proj, wd, wo: [L,B,T,2C], [L,3,C,2C], [L,C,2C] in the stream
        dtype (bf16 or f32), contiguous
    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    global launches
    _check(x0, sb, cond_proj, wd, bd, wo, bo)
    if not on_card(x0, "residual_stack_train_fwd"):
        return residual_stack_train_fwd_plain(x0, sb, cond_proj, wd, bd, wo,
                                              bo, cycle=cycle)
    b, t, c = x0.shape
    n_layers, sd = cond_proj.shape[0], wd.dtype
    plan = tc_plan(b, t, c, dtype=sd)
    x = x0.clone()                                  # running state, in place
    y, h = layer_scratch(b, t, plan.cp, sd, x0.device)
    skip = torch.empty(b, t, c, dtype=torch.float32, device=x0.device)
    xsave = torch.empty(n_layers, b, t, c, dtype=sd, device=x0.device)
    sbf, bdf, bof = (a.float().contiguous() for a in (sb, bd, bo))
    wdp, wop = pack_layers(wd, wo, plan.cp)
    err = _build.lib().dsvc_stack_train_fwd(
        _DTYPES[x0.dtype], _DTYPES[sd], x.data_ptr(), y.data_ptr(),
        h.data_ptr(), skip.data_ptr(), xsave.data_ptr(), sbf.data_ptr(),
        b * c, c, cond_proj.data_ptr(), wdp.data_ptr(), bdf.data_ptr(),
        wop.data_ptr(), bof.data_ptr(), b, t, c, n_layers, cycle,
        plan.c_array(), _build.stream())
    _build.check(err, "dsvc_stack_train_fwd")
    launches += 1
    return skip, xsave


def check_bwd(xsave, sb, cond_proj, wd, bd, wo, dout, dout_dtype,
              what: str) -> None:
    """Shapes, devices and dtypes of a backward's operands: ``xsave``,
    ``cond_proj``, ``wd`` and ``wo`` in the stream dtype, ``dout`` [B,T,C]
    in ``dout_dtype``, contiguous."""
    # dout stands in for the state: shapes, devices, a valid dtype pair
    _check(dout, sb, cond_proj, wd, bd, wo, bd)
    if tuple(xsave.shape) != (cond_proj.shape[0], *dout.shape):
        raise ValueError(f"{what}: xsave {tuple(xsave.shape)} does not match "
                         "dout")
    for name, a, dt in (("xsave", xsave, wd.dtype), ("dout", dout, dout_dtype)):
        if a.dtype != dt or not a.is_contiguous() or a.device != wd.device:
            raise ValueError(f"{what}: {name} must be contiguous {dt} on "
                             f"{wd.device}")


def bwd_scratch(b: int, t: int, c: int, seg_rows: int, plan: TrainPlan, sd,
                dev):
    """Scratch of the backward (``diffnet_train_bwd.cuh:run_bwd``) with
    weight-grad segments of ``seg_rows`` rows, in the C entry points'
    order: z, do, dy (f32); the seven operand planes in the stream dtype
    ``sd``, zeroed (:func:`operand_planes`); wpart, cpart (f32)."""
    rows = b * t
    nseg = rows // seg_rows
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(rows, 2 * c, **f32), torch.empty(rows, 2 * c, **f32),
            torch.empty(rows, c, **f32),
            *operand_planes(rows, plan, sd, dev),
            torch.empty(plan.nchunk, 3 * c, 2 * c, **f32),
            torch.empty(max(nseg * -(-seg_rows // CCH) * 2 * c,
                            b * -(-t // CCH) * c), **f32))


def operand_planes(rows: int, plan: TrainPlan, sd, dev):
    """The backward's product operands for one layer, zeroed (pad channels
    and pad positions stay zero): ys [R, cp], yt [3cp, rp], ht [cp, rp], dos
    [R, 2cp], dot [2cp, rp], dzs [R, 2cp], dzt [2cp, rp], each with
    ``plan.planes`` planes in front (hi and lo at f32)."""
    cp, rp, p = plan.cp, plan.rp, plan.planes
    shapes = ((rows, cp), (3 * cp, rp), (cp, rp), (rows, 2 * cp),
              (2 * cp, rp), (rows, 2 * cp), (2 * cp, rp))
    return tuple(torch.zeros(p, *s, dtype=sd, device=dev) for s in shapes)


def bwd_outputs(n_layers: int, b: int, t: int, c: int, dcp_dtype, dev):
    """(dx0, dsb, dcp, dwd, dbd, dwo, dbo), uninitialised, on ``dev``."""
    f32 = dict(dtype=torch.float32, device=dev)
    return (torch.empty(b, t, c, **f32), torch.empty(n_layers, b, c, **f32),
            torch.empty(n_layers, b, t, 2 * c, dtype=dcp_dtype, device=dev),
            torch.empty(n_layers, 3, c, 2 * c, **f32),
            torch.empty(n_layers, 2 * c, **f32),
            torch.empty(n_layers, c, 2 * c, **f32),
            torch.empty(n_layers, 2 * c, **f32))


def residual_stack_train_batched_bwd(xsave, sb, cond_proj, wd, bd, wo, dout,
                                     *, cycle: int):
    """Batch-fused backward: (dx0, dsb, dcp, dwd, dbd, dwo, dbo) as
    :func:`residual_stack_train_batched_bwd_plain` returns them.  ``xsave``,
    ``cond_proj``, ``wd``, ``wo`` and ``dout`` in the stream dtype."""
    global launches, bwd_launches, bwd_launches_f32
    n_layers, b, t, c = xsave.shape
    check_bwd(xsave, sb, cond_proj, wd, bd, wo, dout, wd.dtype,
              "residual_stack_train_batched_bwd")
    if not on_card(xsave, "residual_stack_train_batched_bwd"):
        return residual_stack_train_batched_bwd_plain(
            xsave, sb, cond_proj, wd, bd, wo, dout, cycle=cycle)
    sd = wd.dtype
    plan = train_plan(b, t, c, b * t, sd)
    out = bwd_outputs(n_layers, b, t, c, sd, xsave.device)
    scratch = bwd_scratch(b, t, c, b * t, plan, sd, xsave.device)
    sbf, bdf = sb.float().contiguous(), bd.float().contiguous()
    packed = pack_bwd(wd, wo, plan.cp)
    err = _build.lib().dsvc_stack_train_bwd(
        _DTYPES[sd], xsave.data_ptr(), sbf.data_ptr(), cond_proj.data_ptr(),
        *(w.data_ptr() for w in packed), bdf.data_ptr(), dout.data_ptr(),
        *(a.data_ptr() for a in out), *(a.data_ptr() for a in scratch),
        b, t, c, n_layers, cycle, RCH, CCH, plan.c_array(), _build.stream())
    _build.check(err, "dsvc_stack_train_bwd")
    launches += 1
    bwd_launches += 1
    if sd == torch.float32:
        bwd_launches_f32 += 1
    return out


class ResidualStackTrainFn(torch.autograd.Function):
    """Differentiable residual stack of both training routes (the JAX custom
    VJPs of ``residual_stack_train_batched`` and ``residual_stack_train``):
    the forward saves x_l with cond_proj, wd and wo rounded to the stream
    dtype ``sd`` on the way in; the backward is ``bwd`` (K4's batch-fused or
    K5's per-sample kernel) with the skip cotangent cast to ``dout_dtype``.
    Cotangents come back in the primal dtypes."""

    @staticmethod
    def forward(ctx, x0, sb, cond_proj, wd, bd, wo, bo, cycle: int, sd, bwd,
                dout_dtype):
        cp, wds, wos = (a.to(sd).contiguous() for a in (cond_proj, wd, wo))
        skip, xsave = residual_stack_train_fwd(x0.contiguous(), sb, cp, wds,
                                               bd, wos, bo, cycle=cycle)
        ctx.save_for_backward(xsave, sb, cp, wds, bd, wos)
        ctx.cycle, ctx.bwd, ctx.dout_dtype = cycle, bwd, dout_dtype
        ctx.dtypes = tuple(a.dtype for a in (x0, sb, cond_proj, wd, bd, wo,
                                             bo))
        return skip

    @staticmethod
    def backward(ctx, dout):
        xsave, sb, cp, wds, bd, wos = ctx.saved_tensors
        grads = ctx.bwd(xsave, sb, cp, wds, bd, wos,
                        dout.to(ctx.dout_dtype).contiguous(), cycle=ctx.cycle)
        return (*(g.to(dt) for g, dt in zip(grads, ctx.dtypes)),
                None, None, None, None)


def primal(x0, sb, cond_proj, wd, bd, wo, bo, *, cycle: int, sd):
    """The undifferentiated primal of the training routes (validation's
    loss): K1 (:func:`diffnet_stack.residual_stack`) in the state's dtype
    with cond_proj, wd and wo rounded through ``sd``, as the JAX primal runs
    it (``diffnet_stack.py:442-454`` and ``:693-716``)."""
    xd = x0.dtype
    cp, wds, wos = (a.to(sd).to(xd).contiguous() for a in (cond_proj, wd, wo))
    sbx, bdx, box = (a.to(xd).contiguous() for a in (sb, bd, bo))
    return residual_stack(x0.contiguous(), sbx, cp, wds, bdx, wos, box,
                          cycle=cycle)


def train_stack(args, *, cycle: int, sd, bwd, dout_dtype):
    """A training route of the residual stack on ``args`` = (x0, sb,
    cond_proj, wd, bd, wo, bo): [B,T,C] f32 skip sum.  With grad enabled and
    an input that requires it, :class:`ResidualStackTrainFn` with the
    route's stream dtype, backward and cotangent dtype; without (validation's
    loss), :func:`primal` with the stream dtype."""
    if torch.is_grad_enabled() and any(a.requires_grad for a in args):
        return ResidualStackTrainFn.apply(*args, cycle, sd, bwd, dout_dtype)
    return primal(*args, cycle=cycle, sd=sd)


def residual_stack_train_batched(x0, sb, cond_proj, wd, bd, wo, bo, *,
                                 cycle: int, stream: str = "bf16"):
    """The batched training route of the residual stack: [B,T,C] f32 skip
    sum, streamed in ``stream``; the backward is the batch-fused kernel with
    the cotangent in the stream dtype (:func:`train_stack`)."""
    sd = stream_dtype(stream, x0.dtype)
    return train_stack((x0, sb, cond_proj, wd, bd, wo, bo), cycle=cycle,
                       sd=sd, bwd=residual_stack_train_batched_bwd,
                       dout_dtype=sd)
