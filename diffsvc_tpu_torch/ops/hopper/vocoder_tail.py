"""K3: the (NSF-)HiFiGAN generator tail — Hopper kernels + plain twin.

Replaces ``diffsvc_tpu/ops/pallas/vocoder_tail.py:tail`` (kernel from
``_make_kernel``, plan from ``build_plan``).  CUDA source:
``csrc/vocoder_tail.cu``.

The tail is every generator stage from the tail start stage s0 through
``conv_post`` + tanh: stage s0's resblocks, then per later stage
leaky(0.1) -> ConvTranspose(stride u) -> + NSF injection -> mean over the
resblock kernels (ResBlock1: per dilation leaky -> conv(d) -> leaky ->
conv(1), residual add; ResBlock2: leaky -> conv(d), residual add), and
finally leaky(0.01) -> conv_post -> tanh.  The plan is a static list of
convolutions built from the generator weights; :func:`tail` walks it with
three tensor-core kernels (fused conv1d, fused ConvTranspose1d, and a
ResBlock1 pair of convs in one launch where it fits shared memory),
:func:`tail_plain` walks the same plan with torch convolutions.

The kernels multiply at f32 accuracy as 3xTF32 split products on
``wgmma`` (the arithmetic of ``diffnet_stack.matmul_tf32x3``), each conv an
implicit GEMM: rows are one sample's time steps, N is the whole of Cout
(padded to an N tile of 8-128), K is taps x input channels.  The weights
are split into TF32 hi and lo planes and packed once per plan
(:func:`pack_conv`, :func:`pack_convt`; ``Generator.tail_plan`` caches the
plan until a weight changes); the activations are split in registers.
What bounds it on the H100 (5 s at the openvpi geometry, 216.7 GFLOP):
tensor-core operations at the 128- and 64-channel stages, bytes at the 16-
and 32-channel ones (one activation pass is 14.1 MB at every stage).  The
TPU kernel's 128-lane channel packing and whole-tail VMEM residency do not
carry over (227 KB of shared memory): each conv is one launch on the plain
[B, T, C] layout that reads zeros outside [0, T) of its own input (the TPU
kernel's per-conv boundary re-zeroing) and fuses its pre-activation, bias,
residual, branch mean, injection or tanh.

:func:`tail` is the registered op ``diffsvc_tpu_torch::vocoder_tail`` over
the whole plan (one op, so its counter moves once per tail in an exported
program as in process): the plan's tensors (torch-layout weights for the
plain version, biases, the packed hi/lo planes for the kernels) go in as
tensor lists and its integers as an int list (:func:`flatten_plan`), so a
program holds the packs as constants and packs nothing per call.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build
from .diffnet_stack import pack_split

launches = 0   # tail runs that launched the kernels (CUDA tensors)

# The kernels' compile-time tiles (csrc/vocoder_tail.cu)
BK = 32              # K per block: one 128-byte swizzled row of f32
STAGES = 3           # the ring of weight blocks
WG_ROWS = 64         # rows per warpgroup: one wgmma M
N_TILES = (8, 16, 32, 64, 128)   # the kernels' N tiles (template instances)
ALIGN = 1024         # the 128-byte swizzle repeats every 1 KB
SMEM_MAX = 232448    # shared memory a block can use on the H100
# Position p of each group of 8 K columns holds input channel K8_PERM[p] of
# the group, so that a thread's A fragment (k = t and t + 4) is channels 2t
# and 2t + 1: one 8-byte shared-memory load.
K8_PERM = (0, 2, 4, 6, 1, 3, 5, 7)
# the order csrc/vocoder_tail.cu reads a launch plan in (enum P_*)
PLAN_FIELDS = ("bn", "np", "cin_p", "lda", "kp", "taps", "step", "halo",
               "bm", "win_rows", "threads", "smem", "grid_m", "grid_n",
               "grid_z")


def _round_up(n: int, k: int) -> int:
    return -(-n // k) * k


def n_tile(cout: int) -> int:
    """The N tile for Cout output channels: the next power of two from 8 to
    128 (wider convs take several N tiles)."""
    return min(128, max(8, 1 << (cout - 1).bit_length()))


def padded_cin(cin: int) -> int:
    """Input channels padded to one k8 step."""
    return _round_up(cin, 8)


def window_stride(cin_p: int) -> int:
    """Row stride (floats) of the shared-memory input window: 8 or 24 mod 32,
    so the 8-byte fragment loads of a half-warp hit 32 distinct banks."""
    return cin_p + (8 if cin_p % 16 == 0 else 0)


class TilePlan(NamedTuple):
    """One launch of a tail kernel: N tile bn over np padded output
    channels, input channels padded to cin_p in a window of win_rows rows
    (bm output rows plus the taps' reach) with row stride lda, K = taps x
    cin_p padded to kp, tap j reading window row r + j step for output row
    r, the window starting halo rows before the tile; grid (grid_m, grid_n,
    grid_z) of `threads` threads and `smem` bytes of shared memory."""
    bn: int
    np: int
    cin_p: int
    lda: int
    kp: int
    taps: int
    step: int
    halo: int
    bm: int
    win_rows: int
    threads: int
    smem: int
    grid_m: int
    grid_n: int
    grid_z: int

    def c_array(self):
        """The plan as the C side reads it (``const int*``)."""
        return (ctypes.c_int * len(PLAN_FIELDS))(*self)

    @property
    def ctas(self) -> int:
        return self.grid_m * self.grid_n * self.grid_z


def tile_plan(batch: int, rows: int, cin: int, cout: int, taps: int,
              step: int, halo: int, phases: int = 1) -> TilePlan:
    """The launch plan of a conv (phases = 1) or of a transposed conv's
    phases, over `rows` output rows per sample and phase: two warpgroups
    (bm = 128) where the shared memory allows, else one."""
    bn = n_tile(cout)
    np_ = _round_up(cout, bn)
    cin_p = padded_cin(cin)
    lda = window_stride(cin_p)
    ring = STAGES * 2 * bn * BK * 4
    for bm in (2 * WG_ROWS, WG_ROWS):
        win_rows = bm + (taps - 1) * step
        smem = ALIGN + ring + win_rows * lda * 4
        if smem <= SMEM_MAX:
            break
    else:
        raise ValueError(f"tail: a conv of {cin} channels, {taps} taps "
                         f"{step} apart does not fit shared memory")
    return TilePlan(bn, np_, cin_p, lda, _round_up(taps * cin_p, BK), taps,
                    step, halo, bm, win_rows, bm // WG_ROWS * 128, smem,
                    -(-rows // bm), np_ // bn, batch * phases)


# Widest N tile at which a ResBlock1 pair runs fused: at 64 channels, where
# the products bound the stage, the fused pair (one CTA per SM, conv2 over
# 8% more rows than it writes) was slower on the H100 than two launches.
PAIR_MAX_BN = 32
# the order csrc/vocoder_tail.cu reads a ResBlock1 pair's plan in (Q_*)
PAIR_FIELDS = ("bn", "cin_p", "lda", "taps", "step1", "halo1", "kp1", "kp2",
               "halo2", "bm", "bm_out", "win1", "win2", "threads", "smem",
               "grid_m", "grid_z")


class PairPlan(NamedTuple):
    """One launch of the fused ResBlock1 pair conv2(leaky(conv1(leaky x)))
    + x over C channels (one N tile bn): conv1 (k taps `step1` apart) over
    a window of win1 rows of x makes the bm intermediate rows that conv2 (k
    taps, dilation 1) reads from a window of win2 rows, for bm_out = bm -
    (k - 1) output rows per CTA; grid (grid_m, 1, grid_z)."""
    bn: int
    cin_p: int
    lda: int
    taps: int
    step1: int
    halo1: int
    kp1: int
    kp2: int
    halo2: int
    bm: int
    bm_out: int
    win1: int
    win2: int
    threads: int
    smem: int
    grid_m: int
    grid_z: int

    def c_array(self):
        return (ctypes.c_int * len(PAIR_FIELDS))(*self)

    @property
    def ctas(self) -> int:
        return self.grid_m * self.grid_z


def pair_plan(batch: int, rows: int, c: int, k: int,
              d: int) -> Optional[PairPlan]:
    """The fused pair's plan at two warpgroups (bm = 128 intermediate rows)
    for the narrow, bytes-bound stages (N tile <= PAIR_MAX_BN), or None
    (then the pair runs as two conv launches): also where its two windows
    and the ring do not fit shared memory."""
    bn, cin_p = n_tile(c), padded_cin(c)
    lda, kp = window_stride(cin_p), _round_up(k * cin_p, BK)
    bm = 2 * WG_ROWS
    win1, win2 = bm + (k - 1) * d, bm + k - 1
    smem = ALIGN + STAGES * 2 * bn * BK * 4 + (win1 + win2) * lda * 4
    if bn > PAIR_MAX_BN or k % 2 == 0 or smem > SMEM_MAX:
        return None
    bm_out = bm - (k - 1)
    return PairPlan(bn, cin_p, lda, k, d, (k - 1) * d // 2, kp, kp,
                    (k - 1) // 2, bm, bm_out, win1, win2, bm // WG_ROWS * 128,
                    smem, -(-rows // bm_out), batch)


def pack_taps(w):
    """[taps, Cout, Cin] -> [np, kp] K-major, zero padded: column
    j cin_p + 8 g + p holds input channel 8 g + K8_PERM[p] of tap j (zero
    past Cin), row n output channel n (zero past Cout), K padded to a
    multiple of BK."""
    taps, cout, cin = w.shape
    cin_p, np_ = padded_cin(cin), _round_up(cout, n_tile(cout))
    w = F.pad(w, (0, cin_p - cin, 0, np_ - cout))
    w = w.view(taps, np_, cin_p // 8, 8)[..., list(K8_PERM)]
    w = w.permute(1, 0, 2, 3).reshape(np_, taps * cin_p)
    return F.pad(w, (0, _round_up(taps * cin_p, BK) - taps * cin_p))


def pack_conv(w_t):
    """torch Conv1d weight [Cout, Cin, k] -> [2, np, kp]: the hi and lo
    TF32 planes of :func:`pack_taps` (tap j = kernel position j)."""
    return pack_split(pack_taps(w_t.permute(2, 0, 1)))


def convt_taps(k: int, stride: int) -> int:
    """Input taps per output phase of a transposed conv: ceil(k / u)."""
    return -(-k // stride)


def pack_convt(w_t, stride: int):
    """torch ConvTranspose1d weight [Cin, Cout, k] -> [u, 2, np, kp]: per
    output phase ph, tap q holds kernel position ph + u (nq - 1 - q) (zero
    past k), so that tap q reads input row s - (nq - 1) + q for output
    t = s u + ph - pad."""
    k = w_t.shape[-1]
    nq = convt_taps(k, stride)
    w = F.pad(w_t, (0, nq * stride - k)).permute(2, 1, 0)   # [nq u, Cout, Cin]
    phases = [w[[ph + stride * (nq - 1 - q) for q in range(nq)]]
              for ph in range(stride)]
    return torch.stack([pack_split(pack_taps(p)) for p in phases])


class ConvPlan(NamedTuple):
    w_t: torch.Tensor      # torch Conv1d weight [Cout, Cin, k]
    b: torch.Tensor        # [Cout]
    dilation: int
    pad: int
    wp: torch.Tensor       # [2, np, kp]: pack_conv(w_t)


class ConvTPlan(NamedTuple):
    w_t: torch.Tensor      # torch ConvTranspose1d weight [Cin, Cout, k]
    b: torch.Tensor
    stride: int
    pad: int
    wp: torch.Tensor       # [u, 2, np, kp]: pack_convt(w_t, stride)


class StagePlan(NamedTuple):
    convt: Optional[ConvTPlan]          # None for stage s0
    inject: bool                        # NSF injection after the ConvT
    kind: str                           # "1" (ResBlock1) | "2" (ResBlock2)
    branches: Tuple[Tuple[ConvPlan, ...], ...]   # per resblock kernel


class TailPlan(NamedTuple):
    s0: int
    stages: Tuple[StagePlan, ...]
    post: ConvPlan


def conv_plan(conv: torch.nn.Conv1d, dilation: int, pad: int) -> ConvPlan:
    w_t = conv.weight.detach().float().contiguous()
    return ConvPlan(w_t, conv.bias.detach().float().contiguous(), dilation,
                    pad, pack_conv(w_t))


def convt_plan(conv: torch.nn.ConvTranspose1d, stride: int,
               pad: int) -> ConvTPlan:
    w_t = conv.weight.detach().float().contiguous()
    return ConvTPlan(w_t, conv.bias.detach().float().contiguous(), stride,
                     pad, pack_convt(w_t, stride))


def conv_tile_plan(x_shape, cp: ConvPlan) -> TilePlan:
    b, t, cin = x_shape
    cout, _, k = cp.w_t.shape
    return tile_plan(b, t, cin, cout, k, cp.dilation, cp.pad)


def convt_tile_plan(x_shape, tp: ConvTPlan) -> TilePlan:
    b, t_in, cin = x_shape
    _, cout, k = tp.w_t.shape
    nq = convt_taps(k, tp.stride)
    t_out = (t_in - 1) * tp.stride - 2 * tp.pad + k
    n_s = (t_out - 1 + tp.pad) // tp.stride + 1
    return tile_plan(b, n_s, cin, cout, nq, 1, nq - 1, tp.stride)


# ---------------------------------------------------------------------------
# One conv, two implementations with one contract
# ---------------------------------------------------------------------------

def _conv_plain(x, cp: ConvPlan, slope: float, res=None, acc=None,
                first: bool = False, div: float = 0.0, tanh: bool = False,
                products=F.conv1d):
    y = products(F.leaky_relu(x, slope).transpose(1, 2), cp.w_t, cp.b,
                 padding=cp.pad, dilation=cp.dilation).transpose(1, 2)
    if res is not None:
        y = y + res
    if tanh:
        y = torch.tanh(y)
    if acc is None and not first:
        return y
    s = y if first else acc + y
    return s / div if div > 0 else s


def _convt_plain(x, tp: ConvTPlan, slope: float, inj=None,
                 products=F.conv_transpose1d):
    y = products(F.leaky_relu(x, slope).transpose(1, 2), tp.w_t, tp.b,
                 stride=tp.stride, padding=tp.pad).transpose(1, 2)
    if inj is not None:
        y = y + inj[:, : y.shape[1]]
    return y


def _check_packed(wp, plan: TilePlan, lead=()):
    if tuple(wp.shape) != (*lead, 2, plan.np, plan.kp):
        raise ValueError(f"tail: packed weights {tuple(wp.shape)} do not "
                         f"match the plan's {(*lead, 2, plan.np, plan.kp)}")


def _conv_kernel(x, cp: ConvPlan, slope: float, res=None, acc=None,
                 first: bool = False, div: float = 0.0, tanh: bool = False):
    b, t, cin = x.shape
    cout, _, k = cp.w_t.shape
    if 2 * cp.pad != (k - 1) * cp.dilation:
        raise ValueError("tail: the kernel keeps the length (2 pad == "
                         f"(k - 1) d); got k={k}, d={cp.dilation}, "
                         f"pad={cp.pad}")
    plan = conv_tile_plan(x.shape, cp)
    _check_packed(cp.wp, plan)
    into_acc = first or acc is not None
    if first:
        acc = torch.empty((b, t, cout), dtype=torch.float32, device=x.device)
    out = None if into_acc else torch.empty((b, t, cout), dtype=torch.float32,
                                            device=x.device)
    _build.check(_build.lib().dsvc_tail_conv(
        x.data_ptr(), cp.wp.data_ptr(), cp.b.data_ptr(), _build.ptr(out),
        _build.ptr(res), _build.ptr(acc) if into_acc else None, int(first),
        float(div), b, t, cin, cout, float(slope), int(tanh),
        plan.c_array(), _build.stream()), "dsvc_tail_conv")
    return acc if into_acc else out


def _convt_kernel(x, tp: ConvTPlan, slope: float, inj=None):
    b, t_in, cin = x.shape
    _, cout, k = tp.w_t.shape
    t_out = (t_in - 1) * tp.stride - 2 * tp.pad + k
    if inj is not None and (inj.shape[0] != b or inj.shape[2] != cout
                            or inj.shape[1] < t_out or not inj.is_contiguous()):
        raise ValueError(f"tail: injection {tuple(inj.shape)} does not cover "
                         f"[{b}, {t_out}, {cout}] contiguously")
    plan = convt_tile_plan(x.shape, tp)
    _check_packed(tp.wp, plan, (tp.stride,))
    out = torch.empty((b, t_out, cout), dtype=torch.float32, device=x.device)
    _build.check(_build.lib().dsvc_tail_convt(
        x.data_ptr(), tp.wp.data_ptr(), tp.b.data_ptr(), _build.ptr(inj),
        inj.shape[1] if inj is not None else 0, out.data_ptr(), b, t_in,
        t_out, cin, cout, tp.stride, tp.pad, float(slope), plan.c_array(),
        _build.stream()), "dsvc_tail_convt")
    return out


def _pair_kernel(x, c1: ConvPlan, c2: ConvPlan, acc=None, first=False,
                 div=0.0):
    """A ResBlock1 pair, conv2(leaky(conv1(leaky x))) + x, in one launch
    where :func:`pair_plan` fits, else as two conv launches."""
    b, t, c = x.shape
    k = c1.w_t.shape[-1]
    plan = pair_plan(b, t, c, k, c1.dilation)
    if (plan is None or c2.dilation != 1 or c2.w_t.shape != (c, c, k)
            or c1.w_t.shape != (c, c, k)):
        xt = _conv_kernel(x, c1, 0.1)
        return _conv_kernel(xt, c2, 0.1, res=x, acc=acc, first=first,
                            div=div)
    for cp, kp in ((c1, plan.kp1), (c2, plan.kp2)):
        if tuple(cp.wp.shape) != (2, plan.bn, kp):
            raise ValueError(f"tail: packed weights {tuple(cp.wp.shape)} do "
                             f"not match the pair plan's {(2, plan.bn, kp)}")
    into_acc = first or acc is not None
    if first:
        acc = torch.empty_like(x)
    out = None if into_acc else torch.empty_like(x)
    _build.check(_build.lib().dsvc_tail_pair(
        x.data_ptr(), c1.wp.data_ptr(), c1.b.data_ptr(), c2.wp.data_ptr(),
        c2.b.data_ptr(), _build.ptr(out), _build.ptr(acc) if into_acc
        else None, int(first), float(div), b, t, c, 0.1, plan.c_array(),
        _build.stream()), "dsvc_tail_pair")
    return acc if into_acc else out


def _run(plan: TailPlan, x, injs, conv, convt, pair=None):
    """Walk the plan.  x [B, T, C_s0]; injs: one [B, T', C] injection per
    stage with ``inject`` set, or None (no NSF source: nothing is added).
    ``pair`` runs a ResBlock1 pair at once (else: its two convs)."""
    inj_i = 0
    for st in plan.stages:
        if st.convt is not None:
            inj = None
            if st.inject:
                inj = injs[inj_i] if injs is not None else None
                inj_i += 1
            x = convt(x, st.convt, 0.1, inj)
        n = len(st.branches)
        xs = None
        for bi, convs in enumerate(st.branches):
            step = 2 if st.kind == "1" else 1
            xb = x
            for ci in range(0, len(convs), step):
                # the branch's output goes straight into the mean
                into = (dict(acc=xs, first=bi == 0,
                             div=float(n) if bi == n - 1 else 0.0)
                        if ci + step >= len(convs) else {})
                if step == 2 and pair is not None:
                    y = pair(xb, convs[ci], convs[ci + 1], **into)
                else:
                    xt = conv(xb, convs[ci], 0.1) if step == 2 else xb
                    y = conv(xt, convs[ci + step - 1], 0.1, res=xb, **into)
                if into:
                    xs = y
                else:
                    xb = y
        x = xs
    return conv(x, plan.post, 0.01, tanh=True)[..., 0]


def _check(x, injs):
    if x.dtype != torch.float32 or x.dim() != 3 or not x.is_contiguous():
        raise ValueError(f"tail: x must be contiguous f32 [B, T, C], got "
                         f"{x.dtype} {tuple(x.shape)}")
    for inj in injs or ():
        if inj.device != x.device or inj.dtype != torch.float32:
            raise ValueError("tail: injections must be f32 on x's device")


def tail_plain(x, injs, plan: TailPlan):
    """Plain PyTorch version of :func:`tail` (torch convolutions)."""
    _check(x, injs)
    return _run(plan, x, injs, _conv_plain, _convt_plain)


def flatten_plan(plan: TailPlan):
    """The plan as the op's arguments: (weights, biases, packs, spec).  The
    tensors of every conv in walk order (each stage's ConvT, then its
    branches' convs, then ``conv_post``); ``spec`` the integers: s0, the
    number of stages, per stage (ConvT or not, its stride and pad, NSF
    injection, resblock kind, branches, per branch its convs, per conv its
    dilation and pad), then ``conv_post``'s dilation and pad."""
    weights, biases, packs = [], [], []
    spec = [plan.s0, len(plan.stages)]

    def add(cp):
        weights.append(cp.w_t)
        biases.append(cp.b)
        packs.append(cp.wp)

    for st in plan.stages:
        if st.convt is None:
            spec += [0, 0, 0]
        else:
            spec += [1, st.convt.stride, st.convt.pad]
            add(st.convt)
        spec += [int(st.inject), int(st.kind), len(st.branches)]
        for convs in st.branches:
            spec.append(len(convs))
            for cp in convs:
                spec += [cp.dilation, cp.pad]
                add(cp)
    spec += [plan.post.dilation, plan.post.pad]
    add(plan.post)
    return weights, biases, packs, spec


def unflatten_plan(weights, biases, packs, spec) -> TailPlan:
    """:func:`flatten_plan`'s inverse."""
    it, tensors = iter(spec), iter(zip(weights, biases, packs))
    s0, n_stages = next(it), next(it)
    stages = []
    for _ in range(n_stages):
        has_convt, stride, pad = next(it), next(it), next(it)
        convt = None
        if has_convt:
            w_t, b, wp = next(tensors)
            convt = ConvTPlan(w_t, b, stride, pad, wp)
        inject, kind, n_branches = next(it), next(it), next(it)
        branches = []
        for _ in range(n_branches):
            convs = []
            for _ in range(next(it)):
                dilation, pad = next(it), next(it)
                w_t, b, wp = next(tensors)
                convs.append(ConvPlan(w_t, b, dilation, pad, wp))
            branches.append(tuple(convs))
        stages.append(StagePlan(convt, bool(inject), str(kind),
                                tuple(branches)))
    dilation, pad = next(it), next(it)
    w_t, b, wp = next(tensors)
    return TailPlan(s0, tuple(stages), ConvPlan(w_t, b, dilation, pad, wp))


def tail(x, injs, plan: TailPlan):
    """Run the generator tail.

    :param x: [B, T_s0, C_s0] f32 stage-s0 activation (through stage s0's
        ConvT and injection)
    :param injs: NSF injections [B, T_i, C_i] for the later stages, in
        order (T_i >= the stage length; the excess is ignored), or None
    :returns: [B, T_out] f32 waveform (tanh applied)

    The call goes through the registered op ``diffsvc_tpu_torch::
    vocoder_tail`` (what ``torch.export`` records), the plan flattened
    into its arguments (:func:`flatten_plan`): CPU tensors take the plain
    version, CUDA tensors launch the kernels.
    """
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"tail: unsupported device {x.device}")
    return torch.ops.diffsvc_tpu_torch.vocoder_tail(
        x, list(injs or ()), *flatten_plan(plan))


@torch.library.custom_op("diffsvc_tpu_torch::vocoder_tail", mutates_args=(),
                         device_types="cuda")
def _tail_cuda(x: torch.Tensor, injs: list[torch.Tensor],
               weights: list[torch.Tensor], biases: list[torch.Tensor],
               packs: list[torch.Tensor], spec: list[int]) -> torch.Tensor:
    """K3 on the card: the plan's convs, one kernel launch each (a
    ResBlock1 pair of the narrow stages in one).  Every implementation
    checks its operands (a loaded program calls the op directly)."""
    global launches
    _check(x, injs)
    if any(t.device != x.device for t in (*weights, *biases, *packs)):
        raise ValueError("tail: plan weights are not on x's device")
    plan = unflatten_plan(weights, biases, packs, spec)
    y = _run(plan, x, injs or None, _conv_kernel, _convt_kernel,
             _pair_kernel)
    launches += 1
    return y


@_tail_cuda.register_kernel("cpu")
def _tail_cpu(x, injs, weights, biases, packs, spec):
    _check(x, injs)
    return _run(unflatten_plan(weights, biases, packs, spec), x,
                injs or None, _conv_plain, _convt_plain)


@_tail_cuda.register_fake
def _tail_fake(x, injs, weights, biases, packs, spec):
    _check(x, injs)
    plan = unflatten_plan(weights, biases, packs, spec)
    t = x.shape[1]
    for st in plan.stages:
        if st.convt is not None:
            t = ((t - 1) * st.convt.stride - 2 * st.convt.pad
                 + st.convt.w_t.shape[-1])
    return x.new_empty((x.shape[0], t))
