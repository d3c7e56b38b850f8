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
two kernels (fused conv1d, fused ConvTranspose1d), :func:`tail_plain` walks
the same plan with torch convolutions.

What bounds it on the H100: arithmetic on the CUDA cores (~200 GFLOP for
5 s of audio at the openvpi geometry, mostly the k=3/7/11 resblock convs of
the 128- and 64-channel stages) and, at the late narrow stages, the
activation traffic (a 16-channel f32 stage of 5 s is 14 MB per pass).  The
TPU kernel's 128-lane channel packing and VMEM residency are TPU-only and
not carried over: the layout is plain [B, T, C], each conv reads zeros
outside [0, T) of its own input (the TPU kernel's per-conv boundary
re-zeroing), and every launch fuses its pre-activation, bias, residual and
branch-mean.  f32 only in this first kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

launches = 0   # tail runs that launched the kernels (CUDA tensors)


class ConvPlan(NamedTuple):
    w: torch.Tensor        # [k, Cin, Cout] kernel layout
    w_t: torch.Tensor      # torch Conv1d weight [Cout, Cin, k]
    b: torch.Tensor        # [Cout]
    dilation: int
    pad: int


class ConvTPlan(NamedTuple):
    w: torch.Tensor        # [k, Cin, Cout] kernel layout
    w_t: torch.Tensor      # torch ConvTranspose1d weight [Cin, Cout, k]
    b: torch.Tensor
    stride: int
    pad: int


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
    return ConvPlan(w_t.permute(2, 1, 0).contiguous(), w_t,
                    conv.bias.detach().float().contiguous(), dilation, pad)


def convt_plan(conv: torch.nn.ConvTranspose1d, stride: int,
               pad: int) -> ConvTPlan:
    w_t = conv.weight.detach().float().contiguous()
    return ConvTPlan(w_t.permute(2, 0, 1).contiguous(), w_t,
                     conv.bias.detach().float().contiguous(), stride, pad)


# ---------------------------------------------------------------------------
# One conv, two implementations with one contract
# ---------------------------------------------------------------------------

def _conv_plain(x, cp: ConvPlan, slope: float, res=None, acc=None,
                first: bool = False, div: float = 0.0, tanh: bool = False):
    y = F.conv1d(F.leaky_relu(x, slope).transpose(1, 2), cp.w_t, cp.b,
                 padding=cp.pad, dilation=cp.dilation).transpose(1, 2)
    if res is not None:
        y = y + res
    if tanh:
        y = torch.tanh(y)
    if acc is None and not first:
        return y
    s = y if first else acc + y
    return s / div if div > 0 else s


def _convt_plain(x, tp: ConvTPlan, slope: float, inj=None):
    y = F.conv_transpose1d(F.leaky_relu(x, slope).transpose(1, 2), tp.w_t,
                           tp.b, stride=tp.stride,
                           padding=tp.pad).transpose(1, 2)
    if inj is not None:
        y = y + inj[:, : y.shape[1]]
    return y


def _conv_kernel(x, cp: ConvPlan, slope: float, res=None, acc=None,
                 first: bool = False, div: float = 0.0, tanh: bool = False):
    b, t, cin = x.shape
    k, _, cout = cp.w.shape
    into_acc = first or acc is not None
    if first:
        acc = torch.empty((b, t, cout), dtype=torch.float32, device=x.device)
    out = None if into_acc else torch.empty((b, t, cout), dtype=torch.float32,
                                            device=x.device)
    _build.check(_build.lib().dsvc_tail_conv1d(
        x.data_ptr(), cp.w.data_ptr(), cp.b.data_ptr(), _build.ptr(out),
        _build.ptr(res), _build.ptr(acc) if into_acc else None, int(first),
        float(div), b, t, cin, cout, k, cp.dilation, cp.pad, float(slope), 1,
        int(tanh), _build.stream()), "dsvc_tail_conv1d")
    return acc if into_acc else out


def _convt_kernel(x, tp: ConvTPlan, slope: float, inj=None):
    b, t_in, cin = x.shape
    k, _, cout = tp.w.shape
    t_out = (t_in - 1) * tp.stride - 2 * tp.pad + k
    if inj is not None and (inj.shape[0] != b or inj.shape[2] != cout
                            or inj.shape[1] < t_out or not inj.is_contiguous()):
        raise ValueError(f"tail: injection {tuple(inj.shape)} does not cover "
                         f"[{b}, {t_out}, {cout}] contiguously")
    out = torch.empty((b, t_out, cout), dtype=torch.float32, device=x.device)
    _build.check(_build.lib().dsvc_tail_convt1d(
        x.data_ptr(), tp.w.data_ptr(), tp.b.data_ptr(), _build.ptr(inj),
        inj.shape[1] if inj is not None else 0, out.data_ptr(), b, t_in,
        t_out, cin, cout, k, tp.stride, tp.pad, float(slope),
        _build.stream()), "dsvc_tail_convt1d")
    return out


def _run(plan: TailPlan, x, injs, conv, convt):
    """Walk the plan.  x [B, T, C_s0]; injs: one [B, T', C] injection per
    stage with ``inject`` set, or None (no NSF source: nothing is added)."""
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
                last = ci + step >= len(convs)
                xt = conv(xb, convs[ci], 0.1) if step == 2 else xb
                cp = convs[ci + step - 1]
                if last:   # branch output goes straight into the mean
                    xs = conv(xt, cp, 0.1, res=xb, acc=xs, first=bi == 0,
                              div=float(n) if bi == n - 1 else 0.0)
                else:
                    xb = conv(xt, cp, 0.1, res=xb)
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


def tail(x, injs, plan: TailPlan):
    """Run the generator tail.

    :param x: [B, T_s0, C_s0] f32 stage-s0 activation (through stage s0's
        ConvT and injection)
    :param injs: NSF injections [B, T_i, C_i] for the later stages, in
        order (T_i >= the stage length; the excess is ignored), or None
    :returns: [B, T_out] f32 waveform (tanh applied)
    """
    global launches
    _check(x, injs)
    if x.device.type == "cpu":
        return _run(plan, x, injs, _conv_plain, _convt_plain)
    if x.device.type != "cuda":
        raise ValueError(f"tail: unsupported device {x.device}")
    convs = [plan.post] + [cp for st in plan.stages
                           for cp in (st.convt,) + sum(st.branches, ())]
    if any(cp is not None and cp.w.device != x.device for cp in convs):
        raise ValueError("tail: plan weights are not on x's device")
    y = _run(plan, x, injs, _conv_kernel, _convt_kernel)
    launches += 1
    return y
