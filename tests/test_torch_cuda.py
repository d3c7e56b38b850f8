"""The hand-written Hopper kernels against their plain PyTorch versions on
the card, at ragged shapes the main path does not hit (T, C and channel
counts that are not tile multiples, B > 1, no NSF injection).  Marked
``gpu``: they skip without a CUDA device (run them on the card with
``python -m pytest tests/test_torch_cuda.py -m gpu``).  f32 comparisons run
with TF32 off: the plain versions are true f32, and the port's f32 K1 and
K2 (3xTF32 split products) are held to them at their f32 limits, as K3
(the vocoder tail, 3xTF32 too) is, also at config_44k's own vocoder
widths."""


import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = prev


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_residual_stack_ragged(cuda, dtype, tol):
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(dtype, cuda, b=3, t=77, c=40, layers=6)
    got = ds.residual_stack(**a, cycle=3)
    ref = ds.residual_stack_plain(**a, cycle=3)
    assert _rel(got, ref) <= tol


@pytest.mark.parametrize("stream,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_residual_stack_train_ragged(cuda, stream, tol):
    """K4's forward with save and backward against their plain versions at
    B=3, T=77, C=40, L=6: the skip sum and all seven grads, and the same
    bits when the backward runs twice (no atomics)."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    sd = torch.bfloat16 if stream == "bf16" else torch.float32
    a = stack_inputs(torch.float32, cuda, b=3, t=77, c=40, layers=6)
    for k in ("cond_proj", "wd", "wo"):
        a[k] = a[k].to(sd).contiguous()
    dout = torch.randn(3, 77, 40, device=cuda).to(sd)
    ops = (a["sb"], a["cond_proj"], a["wd"], a["bd"], a["wo"], dout)
    skip, xsave = k4.residual_stack_train_fwd(**a, cycle=3)
    got = k4.residual_stack_train_batched_bwd(xsave, *ops, cycle=3)
    skip_p, xsave_p = k4.residual_stack_train_fwd_plain(**a, cycle=3)
    ref = k4.residual_stack_train_batched_bwd_plain(xsave_p, *ops, cycle=3)
    assert _rel(skip, skip_p) <= tol
    for x, y in zip(got, ref):
        assert _rel(x, y) <= tol
    again = k4.residual_stack_train_batched_bwd(xsave, *ops, cycle=3)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_residual_stack_train_per_sample_ragged(cuda, dtype, tol):
    """K5's backward (after K4's forward at the state's dtype) against its
    plain version at B=3, T=77, C=40, L=6 with an f32 cotangent: all seven
    grads; and the batch equals, bit for bit, its B=1 runs (dx0, dsb, dcp
    per sample; weight and bias grads as their in-order sum)."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_per_sample as k5
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(dtype, cuda, b=3, t=77, c=40, layers=6)
    dout = torch.randn(3, 77, 40, device=cuda)
    ops = (a["sb"], a["cond_proj"], a["wd"], a["bd"], a["wo"])
    _, xsave = k4.residual_stack_train_fwd(**a, cycle=3)
    got = k5.residual_stack_train_bwd(xsave, *ops, dout, cycle=3)
    ref = k5.residual_stack_train_bwd_plain(xsave, *ops, dout, cycle=3)
    for x, y in zip(got, ref):
        assert x.dtype == torch.float32 and _rel(x, y) <= tol
    ones = [k5.residual_stack_train_bwd(
        xsave[:, i:i + 1].contiguous(), a["sb"][:, i:i + 1],
        a["cond_proj"][:, i:i + 1].contiguous(), a["wd"], a["bd"], a["wo"],
        dout[i:i + 1], cycle=3) for i in range(3)]
    assert torch.equal(got[0], torch.cat([o[0] for o in ones]))
    for k in (1, 2):
        assert torch.equal(got[k], torch.cat([o[k] for o in ones], dim=1))
    for k in range(3, 7):
        tot = torch.zeros_like(got[k])
        for o in ones:
            tot = tot + o[k]
        assert torch.equal(got[k], tot)


@pytest.mark.parametrize("b,t,c", [(3, 1000, 384), (2, 77, 40)])
@pytest.mark.parametrize("stream,tol", [("f32", 1e-5), ("bf16", 1e-2)])
def test_residual_stack_train_tensor_cores(cuda, stream, tol, b, t, c):
    """K4 on wgmma in both streams (bf16 operands; f32 as 3xTF32 split
    products) against the true-f32 plain versions at K4's limits, over 4
    layers with a cycle of 4 (dilations up to 8): B=3, T=1000, C=384, whose
    3000 rows make a second weight-grad chunk of 952 rows (padded to 2048
    positions), and C=40 at T=77 (channels padded to 64); the backward twice
    gives the same bits."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    sd = torch.bfloat16 if stream == "bf16" else torch.float32
    a = stack_inputs(torch.float32, cuda, b=b, t=t, c=c, layers=4)
    for k in ("cond_proj", "wd", "wo"):
        a[k] = a[k].to(sd).contiguous()
    g = torch.Generator().manual_seed(4)
    dout = torch.randn(b, t, c, generator=g).to(cuda, sd)
    ops = (a["sb"], a["cond_proj"], a["wd"], a["bd"], a["wo"], dout)
    skip, xsave = k4.residual_stack_train_fwd(**a, cycle=4)
    got = k4.residual_stack_train_batched_bwd(xsave, *ops, cycle=4)
    skip_p, xsave_p = k4.residual_stack_train_fwd_plain(**a, cycle=4)
    ref = k4.residual_stack_train_batched_bwd_plain(xsave_p, *ops, cycle=4)
    assert _rel(skip, skip_p) <= tol
    for x, y in zip(got, ref):
        assert torch.isfinite(x).all() and _rel(x, y) <= tol
    again = k4.residual_stack_train_batched_bwd(xsave, *ops, cycle=4)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("b,t,c", [(3, 1000, 384), (2, 2100, 40)])
def test_residual_stack_train_per_sample_tensor_cores(cuda, b, t, c):
    """K5 at f32 (3xTF32 on wgmma) against its true-f32 plain version at
    its limit, 4 layers, cycle 4: B=3, T=1000, C=384; and T=2100 at C=40,
    two weight-grad chunks per sample (2048 rows and 52).  The batch equals,
    bit for bit, the in-order sum of its B=1 runs."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_per_sample as k5
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(torch.float32, cuda, b=b, t=t, c=c, layers=4)
    g = torch.Generator().manual_seed(5)
    dout = torch.randn(b, t, c, generator=g).to(cuda)
    ops = (a["sb"], a["cond_proj"], a["wd"], a["bd"], a["wo"])
    _, xsave = k4.residual_stack_train_fwd(**a, cycle=4)
    got = k5.residual_stack_train_bwd(xsave, *ops, dout, cycle=4)
    _, xsave_p = k4.residual_stack_train_fwd_plain(**a, cycle=4)
    ref = k5.residual_stack_train_bwd_plain(xsave_p, *ops, dout, cycle=4)
    for x, y in zip(got, ref):
        assert torch.isfinite(x).all() and _rel(x, y) <= 1e-5
    ones = [k5.residual_stack_train_bwd(
        xsave[:, i:i + 1].contiguous(), a["sb"][:, i:i + 1],
        a["cond_proj"][:, i:i + 1].contiguous(), a["wd"], a["bd"], a["wo"],
        dout[i:i + 1], cycle=4) for i in range(b)]
    assert torch.equal(got[0], torch.cat([o[0] for o in ones]))
    for k in (1, 2):
        assert torch.equal(got[k], torch.cat([o[k] for o in ones], dim=1))
    for k in range(3, 7):
        tot = torch.zeros_like(got[k])
        for o in ones:
            tot = tot + o[k]
        assert torch.equal(got[k], tot)


@pytest.mark.parametrize("dilation", [1, 8, 128])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-2)])
def test_residual_block_ragged(cuda, dtype, tol, dilation):
    """K6 against its plain version at B=2, T=77, C=40 (a dilation of 128
    reads only zeros at the taps), on the tensor-core kernels of its
    dtype."""
    _check_residual_block(cuda, dtype, tol, dilation, b=2, t=77, c=40)


@pytest.mark.parametrize("dilation", [1, 8])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 1e-3)])
def test_residual_block_full_width(cuda, dtype, tol, dilation):
    """K6 at B=3, T=1024, C=384 (no channel padding) against its plain
    version at chip_smoke.py's limits."""
    _check_residual_block(cuda, dtype, tol, dilation, b=3, t=1024, c=384)


def _check_residual_block(cuda, dtype, tol, dilation, b, t, c):
    """K6's outputs against the plain version's; bf16 moves only
    ``launches_tc``, f32 only ``launches_tf32x3``."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_block as k6
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(dtype, cuda, b=b, t=t, c=c, layers=1)
    args = (a["x0"], a["sb"][0].contiguous(), a["cond_proj"][0], a["wd"][0],
            a["bd"][0], a["wo"][0], a["bo"][0])
    before = (k6.launches, k6.launches_tc, k6.launches_tf32x3)
    got = k6.fused_residual_block(*args, dilation=dilation)
    bf16 = dtype == torch.bfloat16
    assert (k6.launches, k6.launches_tc, k6.launches_tf32x3) == (
        before[0] + 1, before[1] + bf16, before[2] + (not bf16))
    ref = k6.fused_residual_block_plain(*args, dilation=dilation)
    for x, y in zip(got, ref):
        assert x.dtype == dtype and torch.isfinite(x).all()
        assert _rel(x, y) <= tol


@pytest.mark.parametrize("sampler", ["plms", "plms-clip", "dpmpp"])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 3e-2)])
def test_plms_ladder_batched(cuda, sampler, dtype, tol):
    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.models.diffusion import make_tables
    from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl
    from diffsvc_tpu_torch.utils.synth import randomize

    torch.manual_seed(0)
    c, m, h, layers, b, t = 48, 20, 24, 4, 2, 70
    net = diffnet.DiffNet(m, h, layers, c, 2)
    randomize(net, 0)   # torch's default init: a nonzero output head
    net = net.to(cuda)
    p = net.stacked(dtype)
    ac = make_tables(100, "linear", 0.02)["alphas_cumprod"]
    if sampler == "dpmpp":
        t_eval, scal = pl.dpmpp_eval_tables(ac, 100, 9)
    else:
        t_eval, scal = pl.plms_eval_tables(ac, 100, 9,
                                           clip=sampler == "plms-clip")
    clip_v = 1.0 if sampler == "plms-clip" else 0.0
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval).to(cuda), c)
    sb = diffnet.step_bias(p, step, dtype).transpose(0, 1).contiguous()
    cond = torch.randn(b, t, h, device=cuda) * 0.5
    cp = diffnet.prepare_cond(net, cond).to(dtype).contiguous()
    x = torch.randn(b, t, m, device=cuda)
    args = (x, torch.from_numpy(scal).to(cuda), sb, cp, p["win"], p["bin"],
            p["wskip"], p["bskip"], p["wout"], p["bout"], p["wd"], p["bd"],
            p["wo"], p["bo"])
    got = pl.plms_ladder(*args, cycle=2, clip_v=clip_v)
    ref = pl.plms_ladder_plain(*args, cycle=2, clip_v=clip_v)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= tol


@pytest.mark.parametrize("b,t,c,layers", [(3, 1000, 384, 4), (2, 77, 40, 4)])
def test_residual_stack_tensor_cores(cuda, b, t, c, layers):
    """K1 at bf16 on its tensor-core kernels against the plain version: B=3
    with a different step bias per sample at T=1000 (not a tile multiple),
    C=384; and C=40 at T=77, where the cycle of 4 reaches a dilation of 8
    (rows on both sides of each sample's edges)."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(torch.bfloat16, cuda, b=b, t=t, c=c, layers=layers)
    assert not torch.equal(a["sb"][:, 0], a["sb"][:, 1])
    before = ds.launches_tc
    got = ds.residual_stack(**a, cycle=4)
    assert ds.launches_tc == before + 1
    assert _rel(got, ds.residual_stack_plain(**a, cycle=4)) <= 1e-2


@pytest.mark.parametrize("b,t,c,m", [(2, 77, 40, 20), (3, 1000, 384, 128)])
def test_plms_ladder_tensor_cores(cuda, b, t, c, m):
    """K2 at bf16 on its tensor-core kernels against the plain version:
    a dilation of 8 at T=77 (C=40, M=20), and M=128 at B=3, T=1000, C=384;
    11 PLMS evaluations, 4 layers."""
    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.models.diffusion import make_tables
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl
    from diffsvc_tpu_torch.utils.synth import randomize

    dt = torch.bfloat16
    torch.manual_seed(0)
    net = diffnet.DiffNet(m, 32, 4, c, 4)
    randomize(net, 0)
    net = net.to(cuda)
    p = net.stacked(dt)
    ac = make_tables(100, "linear", 0.02)["alphas_cumprod"]
    t_eval, scal = pl.plms_eval_tables(ac, 100, 10)
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval).to(cuda), c)
    sb = diffnet.step_bias(p, step, dt).transpose(0, 1).contiguous()
    cond = torch.randn(b, t, 32, device=cuda) * 0.5
    cp = diffnet.prepare_cond(net, cond).to(dt).contiguous()
    x = torch.randn(b, t, m, device=cuda)
    args = (x, torch.from_numpy(scal).to(cuda), sb, cp, p["win"], p["bin"],
            p["wskip"], p["bskip"], p["wout"], p["bout"], p["wd"], p["bd"],
            p["wo"], p["bo"])
    before = (pl.launches_tc, ds.launches_tc)
    got = pl.plms_ladder(*args, cycle=4)
    assert (pl.launches_tc, ds.launches_tc) == (before[0] + 1,
                                                before[1] + len(t_eval))
    ref = pl.plms_ladder_plain(*args, cycle=4)
    assert torch.isfinite(got).all()
    assert _rel(got, ref) <= 3e-2


@pytest.mark.parametrize("b,t,c,layers", [(3, 1000, 384, 4), (2, 77, 40, 4)])
def test_residual_stack_f32_tensor_cores(cuda, b, t, c, layers):
    """K1 at f32 on its 3xTF32 tensor-core kernels against the true-f32
    plain version at K1's f32 limit: B=3 with a different step bias per
    sample at T=1000, C=384; and C=40 at T=77 with a dilation of 8.  Only
    the 3xTF32 counter moves."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(torch.float32, cuda, b=b, t=t, c=c, layers=layers)
    assert not torch.equal(a["sb"][:, 0], a["sb"][:, 1])
    before = (ds.launches_tf32x3, ds.launches_tc)
    got = ds.residual_stack(**a, cycle=4)
    assert (ds.launches_tf32x3, ds.launches_tc) == (before[0] + 1, before[1])
    assert _rel(got, ds.residual_stack_plain(**a, cycle=4)) <= 1e-5


@pytest.mark.parametrize("sampler", ["plms", "plms-clip", "dpmpp"])
def test_plms_ladder_f32_tensor_cores(cuda, sampler):
    """K2 at f32 on its 3xTF32 kernels against the true-f32 plain version
    at B=2, T=300, C=384, M=128 (4 layers, 11 evaluations), for PLMS,
    clipped PLMS and DPM-Solver++; the error is taken on the part of x the
    denoiser put there (the plain ladder with W_out and b_out zeroed as
    the base), at K2's f32 limit.  Only the 3xTF32 counters move: one
    ladder, one K1 stack per evaluation."""
    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.models.diffusion import make_tables
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl
    from diffsvc_tpu_torch.utils.synth import randomize

    dt = torch.float32
    b, t, c, m = 2, 300, 384, 128
    torch.manual_seed(0)
    net = diffnet.DiffNet(m, 32, 4, c, 4)
    randomize(net, 0)
    net = net.to(cuda)
    p = net.stacked(dt)
    ac = make_tables(100, "linear", 0.02)["alphas_cumprod"]
    if sampler == "dpmpp":
        t_eval, scal = pl.dpmpp_eval_tables(ac, 100, 10)
    else:
        t_eval, scal = pl.plms_eval_tables(ac, 100, 10,
                                           clip=sampler == "plms-clip")
    clip_v = 1.0 if sampler == "plms-clip" else 0.0
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval).to(cuda), c)
    sb = diffnet.step_bias(p, step, dt).transpose(0, 1).contiguous()
    cond = torch.randn(b, t, 32, device=cuda) * 0.5
    cp = diffnet.prepare_cond(net, cond).to(dt).contiguous()
    x = torch.randn(b, t, m, device=cuda)
    args = dict(x_init=x, scal=torch.from_numpy(scal).to(cuda), sb_tab=sb,
                cond_proj=cp, win=p["win"], bin_=p["bin"], wskip=p["wskip"],
                bskip=p["bskip"], wout=p["wout"], bout=p["bout"], wd=p["wd"],
                bd=p["bd"], wo=p["wo"], bo=p["bo"])
    before = (pl.launches_tf32x3, ds.launches_tf32x3, pl.launches_tc,
              ds.launches_tc)
    got = pl.plms_ladder(**args, cycle=4, clip_v=clip_v)
    assert (pl.launches_tf32x3, ds.launches_tf32x3, pl.launches_tc,
            ds.launches_tc) == (before[0] + 1, before[1] + len(t_eval),
                                before[2], before[3])
    ref = pl.plms_ladder_plain(**args, cycle=4, clip_v=clip_v)
    base = pl.plms_ladder_plain(**dict(args, wout=torch.zeros_like(p["wout"]),
                                       bout=torch.zeros_like(p["bout"])),
                                cycle=4, clip_v=clip_v)
    assert torch.isfinite(got).all()
    assert _rel(got - base, ref - base) <= 1e-4


# (generator config, B, mel frames): ragged channels (80 / 40 / 20, odd
# kernel sizes and rates), and config_44k's openvpi widths
VOCODERS = {
    "ragged": (dict(num_mels=16, upsample_initial_channel=160,
                    upsample_rates=(4, 3, 2), upsample_kernel_sizes=(8, 7, 4),
                    resblock_kernel_sizes=(3, 5),
                    resblock_dilation_sizes=((1, 3), (1, 2)),
                    sampling_rate=8000, use_nsf=True), 2, 37),
    # 100 / 50 / 25 channels: windows of 50 and 25 channels load without
    # cp.async (rows not 16-byte aligned)
    "odd": (dict(num_mels=16, upsample_initial_channel=200,
                 upsample_rates=(4, 3, 2), upsample_kernel_sizes=(8, 7, 4),
                 resblock_kernel_sizes=(3, 5),
                 resblock_dilation_sizes=((1, 3), (1, 2)),
                 sampling_rate=8000, use_nsf=True), 1, 29),
    # config_24k's HiFi-GAN V1: 256 / 128 / 64 channels, K3 from stage 1
    "hifigan_v1_24k": (dict(num_mels=80, upsample_initial_channel=512,
                            upsample_rates=(8, 8, 2),
                            upsample_kernel_sizes=(16, 16, 4),
                            resblock_kernel_sizes=(3, 7, 11),
                            resblock_dilation_sizes=((1, 3, 5),) * 3,
                            sampling_rate=24000, use_nsf=True), 2, 190),
    "openvpi": (dict(num_mels=128, upsample_initial_channel=512,
                     upsample_rates=(8, 8, 2, 2, 2),
                     upsample_kernel_sizes=(16, 16, 4, 4, 4),
                     resblock_kernel_sizes=(3, 7, 11),
                     resblock_dilation_sizes=((1, 3, 5),) * 3,
                     sampling_rate=44100, use_nsf=True), 1, 300),
}


def _vocoder(cuda, name, use_f0=True):
    from diffsvc_tpu_torch.vocoders import generator as gen_mod

    cfg_kw, b, t = VOCODERS[name]
    torch.manual_seed(0)
    cfg = gen_mod.HifiGanConfig(**cfg_kw)
    gen = gen_mod.Generator(cfg).to(cuda)
    g = torch.Generator().manual_seed(1)
    mel = torch.randn(b, t, cfg.num_mels, generator=g).to(cuda)
    f0 = torch.full((b, t), 180.0, device=cuda) if use_f0 else None
    hop = int(np.prod(cfg.upsample_rates))
    randoms = gen_mod.draw_randoms(b, t * hop, cfg.harmonic_num, g)
    return gen, mel, f0, tuple(r.to(cuda) for r in randoms), (b, t * hop)


@pytest.mark.parametrize("name,use_f0", [("ragged", True), ("ragged", False),
                                         ("odd", True), ("openvpi", True),
                                         ("hifigan_v1_24k", True)])
def test_vocoder_tail_ragged(cuda, name, use_f0):
    """K3 (through apply_serving) against the plain generator: ragged
    channels at B=2, T=37 with and without the NSF source, channel counts
    that are not multiples of 4, the openvpi widths at 300 frames and
    config_24k's HiFi-GAN V1 at B=2, 190 frames."""
    from diffsvc_tpu_torch.ops.hopper import vocoder_tail as vt
    from diffsvc_tpu_torch.vocoders import generator as gen_mod

    gen, mel, f0, randoms, shape = _vocoder(cuda, name, use_f0)
    before = vt.launches
    with torch.no_grad():
        got = gen_mod.apply_serving(gen, mel, f0, randoms)
        ref = gen_mod.apply(gen, mel, f0, randoms)
    assert vt.launches == before + 1
    assert got.shape == shape
    assert _rel(got, ref) <= 1e-4


def test_vocoder_serving_is_true_f32_under_default_tf32():
    """With cuDNN's TF32 left on, as PyTorch sets it by default, the
    serving vocoder (its cuDNN prologue and noise convs, then K3) still
    agrees with the true-f32 plain generator at K3's limit."""
    from diffsvc_tpu_torch.vocoders import generator as gen_mod

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    cuda = torch.device("cuda")
    gen, mel, f0, randoms, _ = _vocoder(cuda, "openvpi")
    prev = torch.backends.cudnn.allow_tf32
    try:
        with torch.no_grad():
            torch.backends.cudnn.allow_tf32 = False
            ref = gen_mod.apply(gen, mel, f0, randoms)
            torch.backends.cudnn.allow_tf32 = True
            got = gen_mod.apply_serving(gen, mel, f0, randoms)
            assert torch.backends.cudnn.allow_tf32     # the caller's flag
    finally:
        torch.backends.cudnn.allow_tf32 = prev
    assert _rel(got, ref) <= 1e-4


def test_wrappers_reject_mixed_devices(cuda):
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(torch.float32, cuda, b=1, t=16, c=32, layers=2)
    a["wd"] = a["wd"].cpu()
    with pytest.raises(ValueError):
        ds.residual_stack(**a, cycle=2)


def test_task_draws_on_the_card(cuda):
    """SVCTask's own draws (a train step's t and noise, validation's, and
    sampling's) come from generators on the task's device: a step and its
    repeat from the same state give the same loss, validation repeats, and
    sampling gives finite mels."""
    import numpy as np

    from _torch_fixtures import HID, MEL, TINY_HP
    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.training.task import TRAIN, SVCTask, draw_generator

    hp = HParams(dict(TINY_HP, lr=1e-3, scheduler="step_lr", decay_steps=100,
                      diff_loss_type="l1", diffnet_train_stream_dtype="bf16"))
    task = SVCTask(hp, device=cuda)
    rng = np.random.RandomState(0)
    b, t = 2, 64
    batch = {"hubert": rng.randn(b, t, HID).astype(np.float32),
             "mels": (rng.randn(b, t, MEL) - 3.0).astype(np.float32),
             "mel2ph": np.tile(np.arange(1, t + 1), (b, 1)),
             "f0": np.full((b, t), 200.0, np.float32),
             "uv": np.zeros((b, t), np.float32)}
    assert draw_generator(cuda, task.seed, TRAIN, 0).device.type == "cuda"
    losses = []
    for _ in range(2):
        task.init_state()
        losses.append(float(task.train_step(batch)["loss"]))
    assert np.isfinite(losses[0]) and losses[0] == losses[1]
    assert task.val_step(batch) == task.val_step(batch)
    assert torch.isfinite(task.sample(batch)["mel_out"]).all()


def test_device_tracker_matches_cpu(cuda):
    """The AC tracker's one device pass on the card against the same pass on
    the CPU: the same frames voiced, f0 to test_torch_frontend.py's
    tolerances (cuFFT against the CPU's FFT)."""
    from _torch_fixtures import HOP, SR, voiced_wav
    from diffsvc_tpu_torch.ops import f0_ac

    wavs = torch.from_numpy(np.stack([
        voiced_wav(secs=1.5, f0=f0, gaps=[(0.6, 0.8)], seed=i)
        for i, f0 in enumerate((110.0, 220.0, 440.0))]))
    kw = dict(sr=SR, hop=HOP, f0_min=40.0, f0_max=1100.0)
    ref = f0_ac.track(wavs, **kw).numpy()
    got = f0_ac.track(wavs.to(cuda), **kw).cpu().numpy()
    np.testing.assert_array_equal(got > 0, ref > 0)
    v = ref > 0
    rel = np.abs(got[v] - ref[v]) / ref[v]
    assert (rel <= 1e-4).mean() >= 0.97 and rel.max() <= 5e-3


def test_fused_graph_replay_equals_eager(cuda, tmp_path, monkeypatch):
    """The fused program at the tiny project's widths on the card: each
    bucket captured once; a replay equals the same body run eagerly on the
    card bit for bit; each replay moves K2's and K3's counters by what the
    capture recorded; batched at B=2 against B=1 replays within 1e-5."""
    from _torch_fixtures import TINY_HP, TINY_VOC, voiced_wav
    from diffsvc_tpu_torch.infer.fused import FusedSvc
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.ops.hopper import plms_ladder, vocoder_tail
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.synth import write_hubert
    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    monkeypatch.chdir(tmp_path)          # Svc keeps ./infer_tools caches
    cfg_fn, ckpt = synth.write_project(
        str(tmp_path / "proj"),
        dict(TINY_HP, vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN",
             fused_bucket_samples=64 * 64), TINY_VOC)
    hub = write_hubert(str(tmp_path / "hub.pt"), HubertConfig(
        dim=32, num_heads=2, num_layers=2, ffn_dim=64, proj_dim=32))
    svc = Svc("proj", cfg_fn, False, ckpt, device=cuda)
    hub = hub.to(cuda).eval()
    graphed = FusedSvc(svc.hp, svc.model, svc.vocoder, hub, speedup=10)
    eager = FusedSvc(svc.hp, svc.model, svc.vocoder, hub, speedup=10,
                     cuda_graphs=False)
    wav = voiced_wav(secs=0.9, f0=220.0)
    g = torch.Generator(device=cuda).manual_seed(0)
    geo = graphed.geometry(graphed._padded_length(len(wav)))
    noise = torch.randn(2, geo["pad_t"], 16, generator=g, device=cuda)
    randoms = draw_randoms(2, geo["n_voc"], 8, g, cuda)
    one = dict(init_noise=noise[:1],
               voc_randoms=tuple(r[:1] for r in randoms))
    first = graphed(wav, **one)
    k2, k3 = plms_ladder.launches, vocoder_tail.launches
    again = graphed(wav, **one)
    assert (plms_ladder.launches - k2, vocoder_tail.launches - k3) == (1, 1)
    ref = eager(wav, **one)
    for a, b, c in zip(first, again, ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    assert list(graphed.captures.values()) == [1]
    outs = graphed.batched([wav, wav[:3000]], init_noise=noise,
                           voc_randoms=randoms)
    padded = np.zeros(len(wav), np.float32)
    padded[:3000] = wav[:3000]
    alone = graphed(padded, init_noise=noise[1:],
                    voc_randoms=tuple(r[1:] for r in randoms))
    assert _rel(torch.from_numpy(outs[0][0]),
                torch.from_numpy(first[0])) <= 1e-5
    assert _rel(torch.from_numpy(outs[1][0]),
                torch.from_numpy(alone[0][:3000])) <= 1e-5


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stack_and_ladder_at_24k_widths(cuda, dtype):
    """config_24k's widths: K1 at C=256 (B=2, T=500, 20 layers) and K2 at
    C=256, M=80 (11 PLMS evaluations) against their plain versions at the
    limits of the checks above (K1 1e-5 / 1e-2, K2's eps part 1e-4 / 3e-2)."""
    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.models.diffusion import make_tables
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl
    from diffsvc_tpu_torch.utils.synth import randomize, stack_inputs

    f32 = dtype == torch.float32
    a = stack_inputs(dtype, cuda, b=2, t=500, c=256, layers=20)
    assert _rel(ds.residual_stack(**a, cycle=4),
                ds.residual_stack_plain(**a, cycle=4)) <= (1e-5 if f32
                                                           else 1e-2)
    net = diffnet.DiffNet(80, 256, 20, 256, 4)
    randomize(net, 0)
    net = net.to(cuda)
    p = net.stacked(dtype)
    ac = make_tables(100, "linear", 0.02)["alphas_cumprod"]
    t_eval, scal = pl.plms_eval_tables(ac, 100, 10)
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval).to(cuda), 256)
    sb = diffnet.step_bias(p, step, dtype).transpose(0, 1).contiguous()
    cond = torch.randn(1, 500, 256, device=cuda) * 0.5
    args = dict(x_init=torch.randn(1, 500, 80, device=cuda),
                scal=torch.from_numpy(scal).to(cuda), sb_tab=sb,
                cond_proj=diffnet.prepare_cond(net, cond).to(dtype)
                .contiguous(), win=p["win"], bin_=p["bin"],
                wskip=p["wskip"], bskip=p["bskip"], wout=p["wout"],
                bout=p["bout"], wd=p["wd"], bd=p["bd"], wo=p["wo"],
                bo=p["bo"])
    got = pl.plms_ladder(**args, cycle=4)
    ref = pl.plms_ladder_plain(**args, cycle=4)
    base = pl.plms_ladder_plain(**dict(args, wout=torch.zeros_like(p["wout"]),
                                       bout=torch.zeros_like(p["bout"])),
                                cycle=4)
    assert torch.isfinite(got).all()
    assert _rel(got - base, ref - base) <= (1e-4 if f32 else 3e-2)


def test_k1_packs_once_on_the_card(cuda):
    """K1 reads the packs of its first call on a repeated call; an
    in-place change of a weight repacks and the result follows it."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(torch.float32, cuda, b=1, t=200, c=64, layers=4)
    before = ds.packs
    first = ds.residual_stack(**a, cycle=2)
    again = ds.residual_stack(**a, cycle=2)
    assert ds.packs == before + 1 and torch.equal(first, again)
    with torch.no_grad():
        a["wo"].mul_(0.5)
    got = ds.residual_stack(**a, cycle=2)
    assert ds.packs == before + 2
    assert _rel(got, ds.residual_stack_plain(**a, cycle=2)) <= 1e-5


def test_ddpm_card_matches_cpu(cuda):
    """DDPM (acc=1, K_step 20, f32) on the card through K1 against the CPU
    on the same start and per-step noise: rel-L2 1e-4 on the mel; K1's
    counter moves by one per step, K2's not at all."""
    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.models.diffusion import GaussianDiffusion
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl
    from diffsvc_tpu_torch.utils.synth import randomize

    hp = HParams(audio_num_mel_bins=32, hidden_size=64, residual_layers=8,
                 residual_channels=128, dilation_cycle_length=4,
                 timesteps=20, K_step=20, schedule_type="linear",
                 max_beta=0.02, spec_min=[-6.0], spec_max=[1.5], no_fs2=True,
                 use_pitch_embed=True, use_energy_embed=False, use_uv=False,
                 pitch_norm="log", f0_bin=256, f0_min=50.0, f0_max=1100.0)
    model = GaussianDiffusion(hp)
    randomize(model, 0)
    g = torch.Generator().manual_seed(3)
    t = 300
    batch = {"hubert": torch.randn(1, 150, 64, generator=g) * 0.3,
             "mel2ph": torch.arange(t)[None] // 2 + 1,
             "f0": torch.full((1, t), 7.8), "uv": torch.zeros(1, t),
             "energy": torch.zeros(1, t)}
    noise = torch.randn(1, t, 32, generator=g)
    steps = torch.randn(20, 1, t, 32, generator=g)
    ref = model.infer(batch, speedup=1, init_noise=noise,
                      step_noise=steps)["mel_out"]
    model = model.to(cuda)
    k1, k2 = ds.launches, pl.launches
    got = model.infer({k: v.to(cuda) for k, v in batch.items()}, speedup=1,
                      init_noise=noise, step_noise=steps)["mel_out"]
    assert (ds.launches - k1, pl.launches - k2) == (20, 0)
    assert _rel(got.cpu(), ref) <= 1e-4


def test_crepe_network_card_matches_cpu(cuda):
    """CREPE's network on 64 frames, card against CPU, both true f32:
    rel-L2 of the posteriors 1e-4."""
    from diffsvc_tpu_torch.ops import crepe
    from diffsvc_tpu_torch.utils.synth import randomize, randomize_norms

    model = crepe.Crepe()
    randomize(model, 4)
    randomize_norms(model, 5)
    model.eval()
    wav = torch.randn(63 * 80, generator=torch.Generator().manual_seed(1))
    frames = crepe.frame_audio(wav)
    ref = crepe.posteriors(model, frames)
    got = crepe.posteriors(model.to(cuda), frames.to(cuda))
    assert _rel(got.cpu(), ref) <= 1e-4


def _radam_plain(p, grads, lrs, b1=0.9, b2=0.98, eps=1e-8):
    """optax.radam's update written out on whole tensors, step by step."""
    m, v = torch.zeros_like(p), torch.zeros_like(p)
    rho_inf = 2.0 / (1.0 - b2) - 1.0
    for t, (g, lr) in enumerate(zip(grads, lrs), start=1):
        m = (1.0 - b1) * g + b1 * m
        v = (1.0 - b2) * g * g + b2 * v
        m_hat, v_hat = m / (1.0 - b1 ** t), v / (1.0 - b2 ** t)
        rho = rho_inf - 2.0 * t * b2 ** t / (1.0 - b2 ** t)
        if rho >= 5.0:
            r = ((rho - 4.0) * (rho - 2.0) * rho_inf
                 / ((rho_inf - 4.0) * (rho_inf - 2.0) * rho)) ** 0.5
            m_hat = r * m_hat / (v_hat.sqrt() + eps)
        p = p - lr * m_hat
    return p


def test_radam_on_the_card_matches_plain(cuda):
    """The port's RAdam on the card, 7 steps (6 and 7 rectified) on fixed
    grads, against optax's update written out on the card: the total update
    within rel-L2 1e-6 (from zero values, so the values' own rounding does
    not enter)."""
    from diffsvc_tpu_torch.training.task import RAdam

    g = torch.Generator().manual_seed(0)
    p0 = torch.zeros(4096, device=cuda)
    grads = [torch.randn(4096, generator=g).to(cuda) * 1e-3 for _ in range(7)]
    lrs = [2e-3, 2e-3, 2e-3, 1e-3, 1e-3, 1e-3, 5e-4]
    p = torch.nn.Parameter(p0.clone())
    opt = RAdam([p], lr=lrs[0], betas=(0.9, 0.98))
    for grad, lr in zip(grads, lrs):
        p.grad = grad.clone()
        opt.param_groups[0]["lr"] = lr
        opt.step()
    ref = _radam_plain(p0, grads, lrs)
    assert _rel(p.detach() - p0, ref - p0) <= 1e-6


def test_pe_step_card_matches_cpu(cuda):
    """One pe task step on the card against the same step on the CPU (same
    init, batch): loss and every grad within 1e-4 rel-L2, pe being true f32
    in its forward and backward (``true_f32_convs``) under PyTorch's
    default ``cudnn.allow_tf32`` (True), as a user's training runs."""
    import numpy as np

    from _torch_fixtures import TINY_HP
    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask

    hp = HParams(dict(TINY_HP, lr=1e-3, scheduler="step_lr",
                      decay_steps=100, pitch_type="frame"))
    rng = np.random.RandomState(0)
    batch = {"mels": (rng.randn(3, 64, 16) * 0.5 - 2.5).astype(np.float32),
             "f0": (7.6 + 0.2 * rng.randn(3, 64)).astype(np.float32),
             "uv": (rng.rand(3, 64) < 0.25).astype(np.float32),
             "sample_mask": np.array([1, 1, 0], np.float32)}
    out = []
    torch.backends.cudnn.allow_tf32 = True      # the fixture restores it
    for dev in (cuda, "cpu"):
        task = PitchExtractionTask(hp, device=dev)
        loss, _, grads = task.loss_and_grads(batch)
        out.append((loss.cpu(), [gr.cpu() for gr in grads]))
    (lc, gc), (lp, gp) = out
    assert _rel(lc, lp) <= 1e-4
    for a, b in zip(gc, gp):
        assert _rel(a, b) <= 1e-4 or float(b.norm()) == 0.0


def test_nccl_world1_step_equals_no_process_group(cuda, tmp_path):
    """Three SVCTask steps at the tiny widths (a ragged last batch) under
    nccl at world 1 equal the same steps with no process group bit for
    bit: params and optimizer state (a spawned process, deterministic
    algorithms, cuBLAS's workspace fixed)."""
    import torch.multiprocessing as mp

    import _torch_dist_worker
    from _torch_fixtures import HID, MEL, TINY_HP

    rng = np.random.RandomState(0)
    batches = []
    for n in (3, 3, 2):
        t = 64
        batches.append({
            "hubert": rng.randn(3, t, HID).astype(np.float32),
            "mels": (rng.randn(3, t, MEL) - 3.0).astype(np.float32),
            "mel2ph": np.tile(np.arange(1, t + 1), (3, 1)),
            "f0": np.full((3, t), 200.0, np.float32),
            "uv": np.zeros((3, t), np.float32),
            "sample_mask": (np.arange(3) < n).astype(np.float32)})
    hp = dict(TINY_HP, lr=1e-3, scheduler="step_lr", decay_steps=100,
              diff_loss_type="l1", diffnet_train_stream_dtype="bf16")
    args = str(tmp_path / "args.pt")
    torch.save({"hp": hp, "batches": batches}, args)
    mp.spawn(_torch_dist_worker.nccl_world1,
             args=(str(tmp_path / "store"), args, str(tmp_path)), nprocs=1,
             join=True)
    out = torch.load(str(tmp_path / "rank0.pt"))
    assert out == {"backend": "nccl", "bit_equal": True}


def test_batched_sharded_on_the_card(cuda, tmp_path, monkeypatch):
    """``FusedSvc.batched_sharded`` at the tiny project's widths with two
    replicas on this card: three chunks padded to four, three results, each
    within 1e-5 of ``batched``'s on the same draws; once captured, K2 and
    K3 run once per replica."""
    from _torch_fixtures import TINY_HP, TINY_VOC, voiced_wav
    from diffsvc_tpu_torch.infer.fused import FusedSvc
    from diffsvc_tpu_torch.infer.svc import Svc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.ops.hopper import plms_ladder, vocoder_tail
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.vocoders.generator import draw_randoms

    monkeypatch.chdir(tmp_path)          # Svc keeps ./infer_tools caches
    cfg_fn, ckpt = synth.write_project(
        str(tmp_path / "proj"),
        dict(TINY_HP, vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN"),
        TINY_VOC)
    hub = synth.write_hubert(str(tmp_path / "hub.pt"), HubertConfig(
        dim=32, num_heads=2, num_layers=2, ffn_dim=64, proj_dim=32))
    svc = Svc("proj", cfg_fn, False, ckpt, device=cuda)
    fused = FusedSvc(svc.hp, svc.model, svc.vocoder, hub.to(cuda).eval(),
                     speedup=10)
    wavs = [voiced_wav(secs=0.6 + 0.1 * i, f0=200.0 + 30 * i, seed=i)
            for i in range(3)]
    geo = fused.geometry(max(map(len, wavs)))
    g = torch.Generator(device=cuda).manual_seed(0)
    noise = torch.randn(3, geo["pad_t"], 16, generator=g, device=cuda)
    randoms = draw_randoms(3, geo["n_voc"], 8, g, cuda)
    ref = fused.batched(wavs, init_noise=noise, voc_randoms=randoms)
    kw = dict(init_noise=noise, voc_randoms=randoms)
    fused.batched_sharded(wavs, [cuda, cuda], **kw)    # captures
    k2, k3 = plms_ladder.launches, vocoder_tail.launches
    got = fused.batched_sharded(wavs, [cuda, cuda], **kw)
    assert (plms_ladder.launches - k2, vocoder_tail.launches - k3) == (2, 2)
    assert len(got) == 3
    for (a, _, am), (b, _, bm) in zip(got, ref):
        assert len(a) == len(b)
        assert _rel(torch.from_numpy(a), torch.from_numpy(b)) <= 1e-5
        assert _rel(torch.from_numpy(am), torch.from_numpy(bm)) <= 1e-5


@pytest.mark.parametrize("dtype,tol", [(None, 1e-4), (torch.bfloat16, 3e-2)])
def test_istft_head_card_matches_cpu(cuda, dtype, tol):
    """The iSTFT head (config_44k's geometry at 128 x 2 layers) on the card
    against the CPU on one mel and f0: f32 with TF32 off within 1e-4
    relative L2 (cuFFT's and the host FFT's sums), the bf16 backbone
    within 3e-2; no kernel of the port moves."""
    from diffsvc_tpu_torch.ops.hopper import vocoder_tail
    from diffsvc_tpu_torch.vocoders import istft_head as ih

    cfg = ih.IstftVocoderConfig(dim=128, n_layers=2)
    torch.manual_seed(0)
    head = ih.IstftHead(cfg)
    g = torch.Generator().manual_seed(1)
    mel = torch.randn(2, 40, 128, generator=g) * 0.5 - 4.0
    f0 = 150.0 + 300.0 * torch.rand(2, 40, generator=g)
    k3 = vocoder_tail.launches
    with torch.no_grad():
        ref = ih.apply(head, mel, f0, dtype=dtype)
        got = ih.apply(head.to(cuda), mel.to(cuda), f0.to(cuda),
                       dtype=dtype).cpu()
    assert got.shape == (2, 40 * 512) and torch.isfinite(got).all()
    assert _rel(got, ref) <= tol
    assert vocoder_tail.launches == k3


def test_hifigan_gan_step_card_matches_cpu(cuda):
    """One hifigan-family GAN step (NSF, tiny generator, full MPD and MSD)
    on the card and on the CPU from the same init, crops and draws: both
    losses 1e-4 relative, each D and G grad within 1e-3 relative L2; each
    param the card updated equals optax's first adamw update (weight decay
    1e-4, eps 1e-8, the rate at count 0: p (1 - lr wd) - lr g / (|g| +
    eps)) on the card's own grad, within 1e-3 lr and 4 f32 ulps of the
    value; the port's kernels do not move."""
    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.ops.hopper import plms_ladder, vocoder_tail
    from diffsvc_tpu_torch.training.vocoder_task import VocoderTask
    from test_torch_vocoder_task import BASE, FAMILIES, _batch

    hp = HParams(dict(BASE, **FAMILIES["hifigan"]))
    tasks = [VocoderTask(hp, device=d) for d in ("cpu", cuda)]
    mods = (tasks[1].gen, tasks[1].disc)
    init = [p.detach().double() for m in mods for p in m.parameters()]
    batch = _batch(8)
    draws = tasks[0].draw(tasks[0].batch_on_device(batch),
                          torch.Generator().manual_seed(3))
    before = (plms_ladder.launches, vocoder_tail.launches)
    ms = [t.train_step(batch, draws=tuple(x.to(t.device) for x in draws))
          for t in tasks]
    assert (plms_ladder.launches, vocoder_tail.launches) == before
    for k in ("d_loss", "g_loss"):
        assert abs(float(ms[1][k]) - float(ms[0][k])) <= 1e-4 * abs(
            float(ms[0][k])), k
    for a, b in ((tasks[0].gen, tasks[1].gen),
                 (tasks[0].disc, tasks[1].disc)):
        for (k, p), q in zip(a.named_parameters(), b.parameters()):
            assert _rel(q.grad.cpu(), p.grad) <= 1e-3, k
    lr, ulp = tasks[1].lr, torch.finfo(torch.float32).eps
    params = [p for m in mods for p in m.parameters()]
    for p0, p in zip(init, params):
        g = p.grad.double()
        ref = p0 * (1 - lr * 1e-4) - lr * g / (g.abs() + 1e-8)
        err = (p.detach().double() - ref).abs() - 4 * ulp * ref.abs()
        assert float(err.max()) <= 1e-3 * lr


def test_seq_window_sum_on_the_card(cuda):
    """The (data = 2, seq = 2) grid's four window shares of one step,
    summed, against the unsharded step on the card at C=128, 8 layers
    (halo 30), B=4, T=512: on the plain versions (true f32) every grad
    within 1e-5 rel-L2 and the loss within 1e-6; through K4 at the f32
    stream (3xTF32 products, whose rounding the windows need not repeat)
    within 5e-3, chip_smoke.py's limit on a step through K4, with K4
    moving on every window and K5 not."""
    import contextlib

    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.ops.hopper import (diffnet_stack_per_sample,
                                              diffnet_stack_train as k4)
    from diffsvc_tpu_torch.parallel import dist
    from diffsvc_tpu_torch.training.task import SVCTask

    hp = HParams(
        audio_num_mel_bins=32, hidden_size=64, residual_layers=8,
        residual_channels=128, dilation_cycle_length=4, timesteps=20,
        K_step=20, diff_loss_type="l1", schedule_type="linear",
        max_beta=0.02, keep_bins=32, spec_min=[-6.0], spec_max=[1.5],
        no_fs2=True, use_pitch_embed=True, pitch_norm="log", f0_bin=256,
        f0_min=50.0, f0_max=1100.0, seed=0, lr=1e-3,
        diffnet_train_stream_dtype="f32")
    b, t, u = 4, 512, 256
    rng = np.random.RandomState(0)
    mel2ph = np.tile(np.arange(t) * u // t + 1, (b, 1)).astype(np.int32)
    mel2ph[1, 400:] = 0
    batch = {"hubert": (rng.randn(b, u, 64) * 0.3).astype(np.float32),
             "mel2ph": mel2ph,
             "f0": (7.6 + 0.2 * rng.randn(b, t)).astype(np.float32),
             "uv": np.zeros((b, t), np.float32),
             "energy": np.zeros((b, t), np.float32),
             "mels": (rng.rand(b, t, 32) * 7.5 - 6.0).astype(np.float32),
             "sample_mask": np.array([1, 1, 1, 0], np.float32)}
    task = SVCTask(hp, device=cuda)
    head = task.model.denoise_fn.output_projection
    with torch.no_grad():
        head.weight.copy_(torch.randn(head.weight.shape, generator=torch.
                                      Generator().manual_seed(3)) * 0.2)
    draws = task.draws(batch)

    def step(plain, grid):
        task.grid = dist.Grid(*grid)
        loss, grads = 0.0, None
        with contextlib.ExitStack() as stack:
            if plain:
                for name in ("residual_stack_train_fwd",
                             "residual_stack_train_batched_bwd"):
                    real = getattr(k4, name)
                    stack.callback(setattr, k4, name, real)
                    setattr(k4, name, getattr(k4, name + "_plain"))
            for i in range(grid[0]):
                for j in range(grid[1]):
                    before = (k4.launches, diffnet_stack_per_sample.launches)
                    lo, g = task.loss_and_grads(
                        batch, t=draws[0], noise=draws[1],
                        rows=dist.block(b, i, grid[0]),
                        frames=dist.frames(t, j, grid[1]))
                    assert (k4.launches > before[0]) != plain
                    assert diffnet_stack_per_sample.launches == before[1]
                    loss = loss + lo
                    grads = g if grads is None else \
                        [x + y for x, y in zip(grads, g)]
        return loss, grads

    for plain, tol in ((True, 1e-5), (False, 5e-3)):
        l0, g0 = step(plain, (1, 1))
        loss, grads = step(plain, (2, 2))
        assert abs(float(loss - l0)) <= 1e-6 * abs(float(l0))
        for x, y in zip(grads, g0):
            assert _rel(x, y) <= tol or float(y.norm()) == 0.0


def test_denoise_graph_matches_k1(cuda, tmp_path):
    """The exported denoise graph (traced on the CPU through K1's plain
    version) run by the port's numpy runtime at T = 37 (traced at 10)
    against ``diffnet.apply`` on the card (K1 at f32, 3xTF32) on the same
    noise, step and condition, at K1's f32 limit; and a graph exported with
    one layer's conditioner projection zeroed above it."""
    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.models.diffusion import GaussianDiffusion
    from diffsvc_tpu_torch.onnx import runtime, svc_export
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
    from diffsvc_tpu_torch.utils import synth

    hp = HParams(audio_num_mel_bins=16, hidden_size=24, residual_layers=4,
                 residual_channels=40, dilation_cycle_length=2, timesteps=20,
                 K_step=20, spec_min=[-6.0], spec_max=[1.5], no_fs2=True,
                 use_pitch_embed=True, pitch_norm="log", f0_bin=256,
                 f0_min=50.0, f0_max=1100.0)
    model = GaussianDiffusion(hp)
    synth.randomize(model, 0)
    net = model.denoise_fn.to(cuda)
    paths = svc_export.export_svc_onnx(hp, model, str(tmp_path), "p")
    rng = np.random.RandomState(0)
    x = rng.randn(1, 1, 16, 37).astype(np.float32)
    cond = rng.randn(1, 24, 37).astype(np.float32)
    t = np.asarray([7], np.int64)
    before = ds.launches
    with torch.no_grad():
        want = diffnet.apply(
            net, torch.from_numpy(x[:, 0].transpose(0, 2, 1).copy()).to(cuda),
            torch.from_numpy(t).to(cuda),
            torch.from_numpy(cond.transpose(0, 2, 1).copy()).to(cuda))
    assert ds.launches == before + 1
    want = want.cpu().transpose(1, 2)[:, None]
    with open(paths["denoise"], "rb") as f:
        got = runtime.OnnxRunner(f.read())(x, t, cond)[0]
    assert _rel(torch.from_numpy(got), want) <= 1e-5
    with torch.no_grad():
        model.denoise_fn.residual_layers[1].conditioner_projection \
            .weight.zero_()
    fault = svc_export.export_svc_onnx(hp, model.cpu(), str(tmp_path / "f"),
                                       "p")
    with open(fault["denoise"], "rb") as f:
        bad = runtime.OnnxRunner(f.read())(x, t, cond)[0]
    assert _rel(torch.from_numpy(bad), want) > 1e-5


def test_registered_ops_count_and_refuse_other_devices(cuda, tmp_path):
    """K1, K2 and K3 called as the registered ops that a loaded program
    calls (``torch.ops.diffsvc_tpu_torch.*``) on CUDA tensors launch their
    kernels: each moves its counter (K2 also K1's, once per evaluation) and
    agrees with its plain version; an operand on another device raises
    before any launch; and a ``.pt2`` denoiser exported on the card calls
    K1 when it runs."""
    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.infer import export
    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.models.diffusion import (GaussianDiffusion,
                                                    make_tables)
    from diffsvc_tpu_torch.ops.hopper import (diffnet_stack as ds,
                                              plms_ladder as pl,
                                              vocoder_tail as vt)
    from diffsvc_tpu_torch.utils.synth import randomize, stack_inputs
    from diffsvc_tpu_torch.vocoders import generator as gen_mod

    ops = torch.ops.diffsvc_tpu_torch
    a = stack_inputs(torch.float32, cuda, b=2, t=70, c=40, layers=4)
    k1 = [a[k] for k in ("x0", "sb", "cond_proj", "wd", "bd", "wo", "bo")]
    before = ds.launches
    got = ops.residual_stack(*k1, 2)
    assert ds.launches == before + 1
    assert _rel(got, ds.residual_stack_plain(*k1, cycle=2)) <= 1e-5
    with pytest.raises(ValueError):
        ops.residual_stack(*k1[:3], k1[3].cpu(), *k1[4:], 2)
    assert ds.launches == before + 1

    net = diffnet.DiffNet(20, 24, 4, 40, 2)
    randomize(net, 0)
    net = net.to(cuda)
    p = net.stacked(torch.float32)
    t_eval, scal = pl.plms_eval_tables(
        make_tables(100, "linear", 0.02)["alphas_cumprod"], 100, 9)
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval).to(cuda), 40)
    sb = diffnet.step_bias(p, step, torch.float32).transpose(0, 1)
    cp = diffnet.prepare_cond(net, torch.randn(2, 70, 24, device=cuda))
    k2 = [torch.randn(2, 70, 20, device=cuda),
          torch.from_numpy(scal).to(cuda), sb.contiguous(), cp.contiguous(),
          *(p[k] for k in ("win", "bin", "wskip", "bskip", "wout", "bout",
                           "wd", "bd", "wo", "bo"))]
    before = (pl.launches, ds.launches)
    got = ops.plms_ladder(*k2, 2, 0.0)
    assert (pl.launches, ds.launches) == (before[0] + 1,
                                          before[1] + len(t_eval))
    assert _rel(got, pl.plms_ladder_plain(*k2, cycle=2)) <= 1e-4
    with pytest.raises(ValueError):
        ops.plms_ladder(k2[0].cpu(), *k2[1:], 2, 0.0)
    assert pl.launches == before[0] + 1

    gen, mel, f0, randoms, _ = _vocoder(cuda, "ragged")
    s0 = gen_mod.tail_start_stage(gen.cfg)
    with torch.no_grad():
        har = gen_mod.harmonic_source(gen, f0, randoms)
        x = gen_mod.tail_prologue(gen, mel, har, s0)
        injs = [gen.noise_convs[i](har).transpose(1, 2).contiguous()
                for i in range(s0 + 1, len(gen.cfg.upsample_rates))]
    plan = gen.tail_plan(s0)
    before = vt.launches
    got = ops.vocoder_tail(x, injs, *vt.flatten_plan(plan))
    assert vt.launches == before + 1
    assert _rel(got, vt.tail_plain(x, injs, plan)) <= 1e-4
    with pytest.raises(ValueError):
        ops.vocoder_tail(x.cpu(), injs, *vt.flatten_plan(plan))
    assert vt.launches == before + 1

    hp = HParams(audio_num_mel_bins=16, hidden_size=24, residual_layers=4,
                 residual_channels=40, dilation_cycle_length=2, timesteps=20,
                 K_step=20, spec_min=[-6.0], spec_max=[1.5], no_fs2=True,
                 use_pitch_embed=True, pitch_norm="log", f0_bin=256,
                 f0_min=50.0, f0_max=1100.0, pndm_speedup=5,
                 audio_sample_rate=8000)
    model = GaussianDiffusion(hp)
    randomize(model, 0)
    paths = export.SvcExporter(hp, model).export(str(tmp_path), t_mel=37,
                                                 t_ph=20)
    assert export.program_ops(paths["denoiser"])["ops"] == {
        "residual_stack": 1}
    den = export.load_exported(paths["denoiser"])
    args = (torch.randn(1, 37, 16, device=cuda),
            torch.tensor([7], device=cuda), torch.randn(1, 37, 24,
                                                        device=cuda))
    before = ds.launches
    got = den(*args)
    assert ds.launches == before + 1
    with torch.no_grad():
        want = diffnet.apply(model.denoise_fn, *args)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-4), ("bf16", 2e-2)])
def test_sampler_grid_row_card_matches_cpu(cuda, dtype, tol):
    """One row of ``tools/sampler_quality``'s grid (dpmpp100_clip) through
    K2 on the card against the CPU's plain ladder, from the same weights,
    batch and shared x_T, at the tool's tiny widths: one K2 launch, the
    clamp's range, relative L2 within the ladder's limit (f32: 3xTF32
    against true f32; bf16: rounding flips over 11 evaluations)."""
    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.models.diffusion import GaussianDiffusion
    from diffsvc_tpu_torch.ops.hopper import plms_ladder as k2
    from diffsvc_tpu_torch.tools import sampler_quality as sq
    from diffsvc_tpu_torch.tools.train_demo import profile, tool_hp
    from diffsvc_tpu_torch.utils.synth import randomize

    hp = HParams(dict(tool_hp("unused", profile(True)),
                      diff_compute_dtype=sq.DTYPES[dtype]))
    model = GaussianDiffusion(hp)
    randomize(model, 0)          # torch's init: a nonzero output head
    b, t = 2, 120
    rng = np.random.RandomState(0)
    mel2ph = np.repeat(np.arange(1, t // 2 + 1), 2)[None].repeat(b, 0)
    mel2ph[1, -20:] = 0
    batch = {"hubert": (rng.randn(b, t // 2, 256) * 0.3).astype(np.float32),
             "mel2ph": mel2ph.astype(np.int64),
             "f0": np.full((b, t), 220.0, np.float32),
             "uv": np.zeros((b, t), np.float32),
             "energy": np.zeros((b, t), np.float32)}
    x_T = sq.shared_x_T(b, t, int(hp["audio_num_mel_bins"]))
    row = ("dpmpp", 100, "lambda", 1.0)

    def run(device):
        m = GaussianDiffusion(hp)
        m.load_state_dict(model.state_dict())
        jb = {k: torch.from_numpy(v).to(device) for k, v in batch.items()}
        return torch.from_numpy(sq.sample(m.to(device).eval(), hp, jb, x_T,
                                          *row))

    before = k2.launches
    got = run(cuda)
    assert k2.launches - before == 1
    ref = run("cpu")
    assert torch.isfinite(got).all() and float(got.min()) >= -8.0
    assert float(got.max()) <= 3.0
    assert _rel(got, ref) <= tol


@pytest.mark.parametrize("leg", ["batched_bf16", "kernel_f32", "scan"])
def test_train_step_repeats_bit_for_bit(cuda, leg):
    """The train-stream A/B's legs at B=8 x T=512 (4,096 pitch lookups,
    past nn.Embedding's small-batch path): after two steps (the output
    head no longer zero), the next step taken twice from one state gives
    the same loss, gradients (the conditioner's embeddings among them: the
    port's lookup, ``models.nn.embed``, sums its weight gradient in a fixed
    order), stack-boundary gradients and updated parameters, bit for bit;
    the same step on the next step's draws does not."""
    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.tools import ab_train_stream as ts
    from diffsvc_tpu_torch.tools import step_repeat
    from diffsvc_tpu_torch.training.task import SVCTask

    d = dict(B=8, T=512, C=128, L=4, CYC=2, H=256, n_mel=16, steps=3)
    task = SVCTask(HParams(dict(ts.base_hp(d), **dict(ts.LEGS)[leg])),
                   device=cuda)
    batches = [ts.make_batch(d, i) for i in range(3)]
    k = task.model.K_step
    for s in range(2):
        t, noise = ts.step_draws(s, d, k, cuda)
        task.train_step(batches[s], t=t, noise=noise)
    snap = task.state_dict()
    snap["global_step"] = task.step
    recs = []
    for s in (2, 2, 3):
        task.load_state_dict(snap)
        t, noise = ts.step_draws(s, d, k, cuda)
        recs.append(step_repeat.step_record(task, batches[2], t, noise))
    assert recs[0]["grad:fs2.pitch_embed.weight"].abs().max() > 0
    assert any(key.startswith("k:") for key in recs[0])
    assert step_repeat.differ(recs[0], recs[1]) == []
    assert step_repeat.differ(recs[0], recs[2])
