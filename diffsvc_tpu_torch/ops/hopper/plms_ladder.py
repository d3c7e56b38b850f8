"""K2: the whole sampling ladder (PLMS or DPM-Solver++(2M)) — Hopper kernels
+ plain twin + the float64 host tables.

Replaces ``diffsvc_tpu/ops/pallas/plms_ladder.py:plms_ladder`` (Pallas kernel
``_ladder_kernel``; tables ``plms_eval_tables`` / ``dpmpp_eval_tables``,
copied here because that module imports JAX).  CUDA source:
``csrc/plms_ladder.cu``, plus K1's layer kernels.

Every sampler reduces to ONE program run per denoiser evaluation j, with all
scalars precomputed host-side in float64 (rows p q e0 e1 w0 w1 w2 w3 u v sel
push, see the TPU module's docstring):

    eps    = Denoise(x_eval, t_eval[j])
    g      = clip(p*x_eval + q*eps);   f = e0*x_eval + e1*g
    n      = w0*f + w1*h0 + w2*h1 + w3*h2;   x_next = u*x + v*n
    x_eval <- x_next;  x <- x_next if sel else x;  (h0,h1,h2) <- (f,h0,h1) if push

What bounds it on the H100: K1's arithmetic (48.3 GFLOP per evaluation at
T=1024, C=384, L=20).  The TPU kept x, the history ring and the activation
resident in VMEM for the whole trajectory; [T, C] does not fit one SM's
shared memory at production T, so here ONE C call (``dsvc_plms_ladder``)
loops over the J evaluations on the host side and launches, per
evaluation, the input projection, K1's layers (with step-bias row j) and
one fused epilogue that finishes the denoiser and applies the update.  The
[J, 12] scalar table and the step biases live on the device, and the
workspace (``ladder_workspace``) is allocated once per ladder, so no Python
runs per evaluation and the loop never syncs.  Both dtypes run the
projections and K1 on the tensor cores (wgmma; weights packed K-major by
this wrapper once per ladder, launch plan ``diffnet_stack.tc_plan``): bf16
with bf16 operands, f32 with 3xTF32 split products (the weights split into
hi and lo planes here, ``diffnet_stack.pack_split``), whose epilogue is two
kernels, the skip projection and then the output projection with the
update.  A CUDA graph over the loop (2 + 2L launches per evaluation, 3 + 2L
at f32) is later work.

:func:`plms_ladder` is the registered op ``diffsvc_tpu_torch::plms_ladder``
(CUDA: the kernels; CPU: :func:`plms_ladder_plain`; a fake implementation
for tracing), so an exported sampler program calls the kernels.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import _build, diffnet_stack

NS = 12  # scalar rows per eval: p q e0 e1 w0 w1 w2 w3 u v sel push
launches = 0      # ladder runs that launched the kernels (CUDA tensors)
launches_tc = 0   # of those, the bf16 ones on the tensor-core kernels
launches_tf32x3 = 0   # of those, the f32 ones on the 3xTF32 kernels


# ---------------------------------------------------------------------------
# Host tables (float64 numpy, copied from the TPU module)
# ---------------------------------------------------------------------------

def _alpha_sigma(ac, t):
    """(sqrt(ac), sqrt(1-ac)) with the scan samplers' 1e-12 floors."""
    a = math.sqrt(max(float(ac[t]), 1e-24))
    s = max(math.sqrt(max(1.0 - float(ac[t]), 0.0)), 1e-12)
    return a, s


def _x0_rows(ac, t_eval, clip: bool):
    """(p, q, e0, e1): eps passthrough, or the clipped-x0 eps rewrite."""
    if not clip:
        return 0.0, 1.0, 0.0, 1.0
    a, s = _alpha_sigma(ac, t_eval)
    return 1.0 / a, -s / a, 1.0 / s, -a / s


def plms_eval_tables(alphas_cumprod, t_start: int, interval: int,
                     clip: bool = False):
    """(t_eval [J] int32, scal [J, NS] float32) for the reference PLMS grid
    ``reversed(range(0, t_start, interval))`` with the order-1 bootstrap
    expanded to its own evaluation (J = n_steps + 1)."""
    ac = np.asarray(alphas_cumprod, np.float64)
    n_steps = max(-(-t_start // interval), 1)
    ts = (np.arange(n_steps - 1, -1, -1) * interval).astype(np.int64)

    def upd(t):
        # x' = x + da*(cx*x - ce*n)  ->  u = 1 + da*cx, v = -da*ce
        a_t = ac[t]
        a_prev = ac[max(t - interval, 0)]
        a_t_sq, a_prev_sq = math.sqrt(a_t), math.sqrt(a_prev)
        da = a_prev - a_t
        cx = 1.0 / (a_t_sq * (a_t_sq + a_prev_sq))
        ce = 1.0 / (a_t_sq * (math.sqrt((1 - a_prev) * a_t)
                              + math.sqrt((1 - a_t) * a_prev)))
        return 1.0 + da * cx, -da * ce

    orders = {1: (1.5, -0.5, 0.0, 0.0),
              2: (23 / 12, -16 / 12, 5 / 12, 0.0),
              3: (55 / 24, -59 / 24, 37 / 24, -9 / 24)}
    t_eval, rows = [], []
    # j=0: bootstrap eval at t0 -> x_pred only (sel=0), push f
    t0 = int(ts[0])
    t_eval.append(t0)
    rows.append(_x0_rows(ac, t0, clip) + (1.0, 0.0, 0.0, 0.0) + upd(t0)
                + (0.0, 1.0))
    # j=1: eval at t0_prev; update x at t0 with (f_a + f_b)/2; no push
    t_prev = max(t0 - interval, 0)
    t_eval.append(t_prev)
    rows.append(_x0_rows(ac, t_prev, clip) + (0.5, 0.5, 0.0, 0.0) + upd(t0)
                + (1.0, 0.0))
    # j>=2: steps k=1..n-1, order ramp 2->4
    for k in range(1, n_steps):
        tk = int(ts[k])
        t_eval.append(tk)
        rows.append(_x0_rows(ac, tk, clip) + orders[min(k, 3)] + upd(tk)
                    + (1.0, 1.0))
    return np.asarray(t_eval, np.int32), np.asarray(rows, np.float32)


def dpmpp_eval_tables(alphas_cumprod, t_start: int, interval: int,
                      grid: str = "lambda"):
    """(t_eval [J], scal [J, NS]) for DPM-Solver++(2M): evaluations at
    ``dpmpp_timesteps(...)[:-1]`` plus the final data-prediction evaluation
    at t=0 (J = len(ts))."""
    from ...models.diffusion import dpmpp_timesteps

    ac = np.asarray(alphas_cumprod, np.float64)
    ts = dpmpp_timesteps(ac, t_start, interval, grid)
    lam = 0.5 * (np.log(np.maximum(ac, 1e-24))
                 - np.log(np.maximum(1.0 - ac, 1e-24)))
    t_eval, rows = [], []
    h_prev = None
    for j in range(len(ts) - 1):
        t_cur, t_next = int(ts[j]), int(ts[j + 1])
        a_c, s_c = _alpha_sigma(ac, t_cur)
        a_n, s_n = _alpha_sigma(ac, t_next)
        h = float(lam[t_next] - lam[t_cur])
        if h_prev is None:
            w0, w1 = 1.0, 0.0
        else:
            r = h / h_prev
            w0, w1 = 1.0 + 0.5 * r, -0.5 * r
        h_prev = h
        t_eval.append(t_cur)
        rows.append((1.0 / a_c, -s_c / a_c, 0.0, 1.0,   # f = x0 (clipped)
                     w0, w1, 0.0, 0.0,
                     s_n / s_c, -a_n * math.expm1(-h), 1.0, 1.0))
    # final evaluation at t=0: return the data prediction there
    a_0, s_0 = _alpha_sigma(ac, 0)
    t_eval.append(0)
    rows.append((1.0 / a_0, -s_0 / a_0, 0.0, 1.0,
                 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0))
    return np.asarray(t_eval, np.int32), np.asarray(rows, np.float32)


# ---------------------------------------------------------------------------
# Ladder
# ---------------------------------------------------------------------------

def _update(sc, x, xe, eps, h0, h1, h2, clip_v: float):
    """The 12-scalar update (plain version); returns the new state."""
    p, q, e0, e1, w0, w1, w2, w3, u, v, sel, push = sc
    g = p * xe + q * eps
    if clip_v > 0:
        g = torch.clamp(g, -clip_v, clip_v)
    f = e0 * xe + e1 * g
    n = w0 * f + w1 * h0 + w2 * h1 + w3 * h2
    xn = u * x + v * n
    x = x + sel * (xn - x)
    return (x, xn, h0 + push * (f - h0), h1 + push * (h0 - h1),
            h2 + push * (h1 - h2))


def plms_ladder_plain(x_init, scal, sb_tab, cond_proj, win, bin_, wskip, bskip,
                      wout, bout, wd, bd, wo, bo, *, cycle: int,
                      clip_v: float = 0.0, matmul=torch.matmul):
    """Plain PyTorch version: the same program with the kernels' rounding
    points (matmul operands in the compute dtype, f32 sums, f32 state).
    ``matmul`` computes the products (``diffnet_stack.matmul_tf32x3``: the
    f32 kernels' arithmetic)."""
    dt = win.dtype
    n_layers, b, _, c2 = cond_proj.shape
    c = c2 // 2
    x, xe = x_init, x_init
    h0 = h1 = h2 = torch.zeros_like(x_init)
    for j in range(scal.shape[0]):
        act = torch.relu(matmul(xe.to(dt).float(), win.float())
                         + bin_.float()).to(dt)
        sb = sb_tab[j][:, None, :].expand(n_layers, b, c)
        skip = diffnet_stack.residual_stack_plain(
            act, sb, cond_proj, wd, bd, wo, bo, cycle=cycle, matmul=matmul)
        sk = (skip * (1.0 / math.sqrt(n_layers))).to(dt)
        s1 = torch.relu(matmul(sk.float(), wskip.float())
                        + bskip.float()).to(dt)
        eps = matmul(s1.float(), wout.float()) + bout.float()
        x, xe, h0, h1, h2 = _update(scal[j], x, xe, eps, h0, h1, h2, clip_v)
    return x


def _check(x_init, scal, sb_tab, cond_proj, win, bin_, wskip, bskip, wout,
           bout, wd, bd, wo, bo):
    b, t, m = x_init.shape
    n_layers, _, _, c2 = cond_proj.shape
    c = c2 // 2
    j = scal.shape[0]
    want = {"x_init": (x_init, (b, t, m), torch.float32),
            "scal": (scal, (j, NS), torch.float32),
            "sb_tab": (sb_tab, (j, n_layers, c), win.dtype),
            "cond_proj": (cond_proj, (n_layers, b, t, c2), win.dtype),
            "win": (win, (m, c), win.dtype), "bin": (bin_, (c,), win.dtype),
            "wskip": (wskip, (c, c), win.dtype),
            "bskip": (bskip, (c,), win.dtype),
            "wout": (wout, (c, m), win.dtype), "bout": (bout, (m,), win.dtype),
            "wd": (wd, (n_layers, 3, c, c2), win.dtype),
            "bd": (bd, (n_layers, c2), win.dtype),
            "wo": (wo, (n_layers, c, c2), win.dtype),
            "bo": (bo, (n_layers, c2), win.dtype)}
    for name, (a, shape, dtype) in want.items():
        if tuple(a.shape) != shape or a.dtype != dtype:
            raise ValueError(f"plms_ladder: {name} is {a.dtype}"
                             f"{tuple(a.shape)}, expected {dtype}{shape}")
        if a.device != x_init.device or not a.is_contiguous():
            raise ValueError(f"plms_ladder: {name} must be contiguous on "
                             f"{x_init.device}")


# the workspace in the order dsvc_plms_ladder takes it
WORKSPACE = ("x", "xe", "hist", "xs", "y", "h", "skip")


def ladder_workspace(x_init, c: int, dtype, plan) -> dict:
    """The ladder's buffers, allocated once: the f32 sampler state x and
    x_eval (both x_init) and history [3, B, T, M] (zeros); K1's state xs
    [B, T, C] in the compute dtype and the f32 skip sum [B, T, C]; the
    staged y = x + sb and the gated h with zero pad channels
    (``diffnet_stack.layer_scratch``: [B, T, cp] at bf16, hi and lo planes
    [2, B, T, cp] at f32, where y also carries the scaled skip sum into the
    skip projection and h its output into the output projection)."""
    b, t, m = x_init.shape
    dev = x_init.device
    ws = {"x": x_init.clone(), "xe": x_init.clone(),
          "hist": torch.zeros((3, b, t, m), dtype=torch.float32, device=dev),
          "xs": torch.empty((b, t, c), dtype=dtype, device=dev),
          "skip": torch.empty((b, t, c), dtype=torch.float32, device=dev)}
    ws["y"], ws["h"] = diffnet_stack.layer_scratch(b, t, plan.cp, dtype, dev)
    return ws


def plms_ladder(x_init, scal, sb_tab, cond_proj, win, bin_, wskip, bskip,
                wout, bout, wd, bd, wo, bo, *, cycle: int, clip_v: float = 0.0):
    """Run a full sampling ladder (PLMS or dpmpp, per the scalar tables).

    :param x_init:    [B, T, M] f32 initial state (normed spec domain)
    :param scal:      [J, NS] f32 per-evaluation scalars
    :param sb_tab:    [J, L, C] per-evaluation per-layer step bias (step MLP
                      + diffusion_projection), compute dtype
    :param cond_proj: [L, B, T, 2C] hoisted conditioner projections
    :param win/bin_:  [M, C] / [C] input projection
    :param wskip/bskip: [C, C] / [C] skip projection
    :param wout/bout: [C, M] / [M] output projection
    :param wd/bd/wo/bo: K1's layer weights (see diffnet_stack)
    :param clip_v:    sampler_clip_x0 bound (0 = off)
    :returns:         [B, T, M] float32 final sampler state

    The call goes through the registered op ``diffsvc_tpu_torch::
    plms_ladder`` (what ``torch.export`` records): CPU tensors take the
    plain version; CUDA tensors launch the tensor-core kernels (bf16
    operands, or f32 as 3xTF32 split products).
    """
    if x_init.device.type not in ("cpu", "cuda"):
        raise ValueError(f"plms_ladder: unsupported device {x_init.device}")
    return torch.ops.diffsvc_tpu_torch.plms_ladder(
        x_init, scal, sb_tab, cond_proj, win, bin_, wskip, bskip, wout, bout,
        wd, bd, wo, bo, cycle, float(clip_v))


@torch.library.custom_op("diffsvc_tpu_torch::plms_ladder", mutates_args=(),
                         device_types="cuda")
def _plms_ladder_cuda(x_init: torch.Tensor, scal: torch.Tensor,
                      sb_tab: torch.Tensor, cond_proj: torch.Tensor,
                      win: torch.Tensor, bin_: torch.Tensor,
                      wskip: torch.Tensor, bskip: torch.Tensor,
                      wout: torch.Tensor, bout: torch.Tensor, wd: torch.Tensor,
                      bd: torch.Tensor, wo: torch.Tensor, bo: torch.Tensor,
                      cycle: int, clip_v: float) -> torch.Tensor:
    """K2 on the card: one C call over the J evaluations.  The result is
    the workspace's state x, allocated anew on every call, so it aliases
    no input.  Every implementation checks its operands (a loaded program
    calls the op directly)."""
    global launches, launches_tc, launches_tf32x3
    _check(x_init, scal, sb_tab, cond_proj, win, bin_, wskip, bskip, wout,
           bout, wd, bd, wo, bo)
    ds = diffnet_stack
    b, t, m = x_init.shape
    n_layers, c = cond_proj.shape[0], cond_proj.shape[3] // 2
    n_evals = scal.shape[0]
    dt = win.dtype
    plan = ds.tc_plan(b, t, c, m, dt)
    ws = ladder_workspace(x_init, c, dt, plan)
    # K-major, zero padded (see diffnet_stack.pack_paired); f32: hi and lo
    # planes
    proj = [ds.pack_kmajor(win, plan.mp, plan.cp),
            ds.pack_kmajor(wskip, plan.cp, plan.cp),
            ds.pack_kmajor(wout, plan.cp, plan.mp)]
    if dt == torch.float32:
        proj = [ds.pack_split(w) for w in proj]
    win, wskip, wout = proj
    wd, wo = ds.pack_layers(wd, wo, plan.cp)
    ptr = _build.ptr
    err = _build.lib().dsvc_plms_ladder(
        ds._DTYPES[dt], *(ptr(ws[k]) for k in WORKSPACE),
        *(ptr(a) for a in (scal, sb_tab, cond_proj, win, bin_, wskip, bskip,
                           wout, bout, wd, bd, wo, bo)),
        n_evals, b, t, c, m, n_layers, cycle, float(clip_v),
        plan.c_array(), _build.stream())
    _build.check(err, "dsvc_plms_ladder")
    tc, x3 = dt == torch.bfloat16, dt == torch.float32
    launches += 1
    launches_tc += tc
    launches_tf32x3 += x3
    ds.launches += n_evals      # K1's layers ran once per evaluation
    ds.launches_tc += n_evals * tc
    ds.launches_tf32x3 += n_evals * x3
    return ws["x"]


@_plms_ladder_cuda.register_kernel("cpu")
def _plms_ladder_cpu(x_init, scal, sb_tab, cond_proj, win, bin_, wskip, bskip,
                     wout, bout, wd, bd, wo, bo, cycle, clip_v):
    _check(x_init, scal, sb_tab, cond_proj, win, bin_, wskip, bskip, wout,
           bout, wd, bd, wo, bo)
    return plms_ladder_plain(x_init, scal, sb_tab, cond_proj, win, bin_,
                             wskip, bskip, wout, bout, wd, bd, wo, bo,
                             cycle=cycle, clip_v=clip_v)


@_plms_ladder_cuda.register_fake
def _plms_ladder_fake(x_init, scal, sb_tab, cond_proj, win, bin_, wskip,
                      bskip, wout, bout, wd, bd, wo, bo, cycle, clip_v):
    _check(x_init, scal, sb_tab, cond_proj, win, bin_, wskip, bskip, wout,
           bout, wd, bd, wo, bo)
    return torch.empty_like(x_init)
