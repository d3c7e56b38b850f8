"""K3's tensor-core route on the CPU: the weight packing, the launch plan,
the kernels' index math and the 3xTF32 arithmetic, held against torch's
convolutions and the JAX package's tail.

The kernels (``csrc/vocoder_tail.cu``) read each conv's weights as hi and
lo TF32 planes packed K-major once per plan (``vocoder_tail.pack_conv`` and
``pack_convt``), gather A from a halo'd window of the input (one per CTA,
``vocoder_tail.tile_plan``) and sum a_lo b_hi + a_hi b_lo + a_hi b_hi on
the tensor cores.  Here: the packing round-trips with exact zero padding
at ragged channel counts; the plan fits shared memory and covers every
row at the openvpi stages; an emulation of the kernels' gather over the
packed planes reproduces torch's conv and transposed conv; and the tail run
with each conv's products replaced by the three split products stays
within the f32 limits the tail is held to (2e-4 of JAX's ``apply_tail`` in
interpret mode with f32 taps, as ``test_torch_vocoder.py`` allows the
plain version, and 1e-4 rel-L2 of the plain version, K3's limit in
``chip_smoke.py``), while single-pass TF32 products, or 3xTF32 products
without the weights' lo planes (``chip_smoke.py``'s planted fault), exceed
1e-4.  The kernels themselves run in ``test_torch_cuda.py`` (``gpu``) and
``chip_smoke.py``.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diffsvc_tpu.vocoders import generator as jgen
from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
from diffsvc_tpu_torch.ops.hopper import vocoder_tail as vt
from diffsvc_tpu_torch.vocoders import generator as tgen

from test_torch_vocoder import CFGS, _inputs, _jax_randoms, _pair, _t

# the openvpi 44.1 kHz geometry that config_44k ships, at 5 s (431 frames)
OPENVPI = dict(num_mels=128, upsample_initial_channel=512,
               upsample_rates=(8, 8, 2, 2, 2),
               upsample_kernel_sizes=(16, 16, 4, 4, 4), resblock="1",
               resblock_kernel_sizes=(3, 7, 11),
               resblock_dilation_sizes=((1, 3, 5),) * 3, sampling_rate=44100,
               use_nsf=True)
FRAMES_5S = 431


def _bits(a):
    return a.contiguous().view(torch.int32)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _check_planes(wp, w):
    """wp [2, np, kp] packs w [taps, Cout, Cin]: hi + lo reconstruct it to
    2^-22, both planes are TF32 bit patterns, and every padded entry is +0
    bit for bit."""
    taps, cout, cin = w.shape
    cin_p = vt.padded_cin(cin)
    hi, lo = wp[0], wp[1]
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    # unpack: column j cin_p + 8 g + p is channel 8 g + K8_PERM[p] of tap j
    inv = [vt.K8_PERM.index(c) for c in range(8)]
    full = (hi.double() + lo.double())[:, : taps * cin_p]
    full = full.view(-1, taps, cin_p // 8, 8)[..., inv].reshape(
        -1, taps, cin_p)
    ref = w.double().permute(1, 0, 2)
    assert torch.all((full[:cout, :, :cin] - ref).abs()
                     <= 2.0 ** -22 * ref.abs())
    pad = torch.ones_like(full, dtype=torch.bool)
    pad[:cout, :, :cin] = False
    for plane in (hi, lo):
        p = plane[:, : taps * cin_p].reshape(-1, taps, cin_p // 8, 8)[
            ..., inv].reshape(-1, taps, cin_p)
        assert not _bits(p[pad]).any()               # +0.0 exactly
        assert not _bits(plane[:, taps * cin_p:]).any()


@pytest.mark.parametrize("cin,cout,k", [(20, 20, 3), (40, 40, 7),
                                        (80, 80, 11), (20, 1, 7),
                                        (16, 1, 7), (128, 128, 11),
                                        (25, 25, 5)])
def test_pack_conv_round_trips_with_zero_padding(cin, cout, k):
    g = torch.Generator().manual_seed(cin + k)
    w_t = torch.randn(cout, cin, k, generator=g) * 0.1
    wp = vt.pack_conv(w_t)
    bn = vt.n_tile(cout)
    assert wp.shape == (2, -(-cout // bn) * bn,
                        -(-k * vt.padded_cin(cin) // vt.BK) * vt.BK)
    assert wp.is_contiguous() and wp.dtype == torch.float32
    _check_planes(wp, w_t.permute(2, 0, 1))


@pytest.mark.parametrize("cin,cout,k,u", [(160, 80, 8, 4), (80, 40, 7, 3),
                                          (40, 20, 4, 2), (128, 64, 4, 2)])
def test_pack_convt_phases_round_trip(cin, cout, k, u):
    """Phase ph, tap q holds kernel position ph + u (nq - 1 - q), zero past
    k."""
    g = torch.Generator().manual_seed(k * u)
    w_t = torch.randn(cin, cout, k, generator=g) * 0.1
    wp = vt.pack_convt(w_t, u)
    nq = vt.convt_taps(k, u)
    assert wp.shape[:2] == (u, 2)
    for ph in range(u):
        w = torch.zeros(nq, cout, cin)
        for q in range(nq):
            j = ph + u * (nq - 1 - q)
            if j < k:
                w[q] = w_t[:, :, j].t()
        _check_planes(wp[ph], w)


def _stage_convs(cfg_kw, frames):
    """(name, x shape, plan) of every launch of the tail, as ``tail`` walks
    it for one sample of ``frames`` mel frames."""
    torch.manual_seed(0)
    gen = tgen.Generator(tgen.HifiGanConfig(**cfg_kw))
    s0 = tgen.tail_start_stage(gen.cfg)
    plan = gen.tail_plan(s0)
    rates = cfg_kw["upsample_rates"]
    t = frames * int(np.prod(rates[: s0 + 1]))
    c = tgen.stage_channels(gen.cfg, s0)
    out = []
    for i, st in enumerate(plan.stages):
        if st.convt is not None:
            out.append((f"stage {s0 + i} convt", (1, t, c),
                        vt.convt_tile_plan((1, t, c), st.convt)))
            t, c = t * st.convt.stride, st.convt.w_t.shape[1]
        for br in st.branches:
            for cp in br:
                out.append((f"stage {s0 + i} k{cp.w_t.shape[-1]} "
                            f"d{cp.dilation}", (1, t, c),
                            vt.conv_tile_plan((1, t, c), cp)))
    out.append(("conv_post", (1, t, c),
                vt.conv_tile_plan((1, t, c), plan.post)))
    return out, t


def test_tile_plan_fits_and_covers_openvpi_stages():
    launches, samples = _stage_convs(OPENVPI, FRAMES_5S)
    assert samples == FRAMES_5S * 512
    # 18 resblock convs per stage, 3 ConvTs, conv_post: 76 launches
    assert len(launches) == 4 * 18 + 3 + 1
    bns = {}
    for name, (b, t, cin), p in launches:
        assert p.smem <= vt.SMEM_MAX, name
        assert p.smem >= (vt.ALIGN + vt.STAGES * 2 * p.bn * vt.BK * 4
                          + p.win_rows * p.lda * 4), name
        assert p.bn in vt.N_TILES and p.np % p.bn == 0
        assert p.lda % 32 in (8, 24) and p.lda >= p.cin_p >= cin
        assert p.kp % vt.BK == 0 and p.kp >= p.taps * p.cin_p
        assert p.threads == p.bm // vt.WG_ROWS * 128
        assert p.win_rows == p.bm + (p.taps - 1) * p.step
        if "convt" in name:
            u = p.grid_z // b
            rows = (t * u - 1 + (4 - u) // 2) // u + 1
            # every output row t_o = s u + ph - pad of [0, 2t) has its s
            assert p.grid_m * p.bm >= rows and u == 2 and p.taps == 2
        else:
            rows = t
            assert 2 * p.halo == (p.taps - 1) * p.step
        assert (p.grid_m - 1) * p.bm < rows <= p.grid_m * p.bm, name
        bns.setdefault(name.split(" k")[0].split(" convt")[0], set()).add(
            (p.bn, p.bm))
    # N is the whole of Cout: 128 / 64 / 32 / 16 channels, 8 for conv_post;
    # two warpgroups (128 rows) everywhere at this geometry
    assert bns == {"stage 1": {(128, 128)}, "stage 2": {(64, 128)},
                   "stage 3": {(32, 128)}, "stage 4": {(16, 128)},
                   "conv_post": {(8, 128)}}
    widest = max(p.smem for _, _, p in launches)
    assert widest == 1024 + 3 * 32768 + (128 + 50) * 136 * 4


# ---------------------------------------------------------------------------
# The kernels' gather over the packed planes, emulated
# ---------------------------------------------------------------------------

# a thread's fragment: k positions t and t + 4 of a k8 step are the
# adjacent channels 2t and 2t + 1 of its 8-byte window load
_FRAGMENT_CHANNEL = [2 * p if p < 4 else 2 * (p - 4) + 1 for p in range(8)]


def _gather(xl, rows, taps, step, w0, cin_p, kp):
    """A [B, rows, kp] as the kernels read it: row r, column tap cin_p +
    8 g + p is channel 8 g + _FRAGMENT_CHANNEL[p] of input row w0 + r + tap
    step (zero outside [0, T) and past Cin)."""
    b, t, cin = xl.shape
    xp = F.pad(xl, (0, cin_p - cin))
    cols = []
    for tap in range(taps):
        idx = torch.arange(rows) + w0 + tap * step
        ok = ((idx >= 0) & (idx < t)).float()[None, :, None]
        g = xp[:, idx.clamp(0, t - 1)] * ok
        cols.append(g.view(b, rows, cin_p // 8, 8)[..., _FRAGMENT_CHANNEL]
                    .reshape(b, rows, cin_p))
    a = torch.cat(cols, -1)
    return F.pad(a, (0, kp - taps * cin_p))


def _x3(a, wp):
    a_hi, a_lo = ds.split_tf32(a)
    return (a_lo @ wp[0].t() + a_hi @ wp[1].t()) + a_hi @ wp[0].t()


@pytest.mark.parametrize("cin,cout,k,d", [(20, 20, 3, 1), (40, 40, 7, 3),
                                          (80, 80, 11, 5), (16, 1, 7, 1),
                                          (128, 128, 11, 5)])
def test_emulated_conv_matches_torch(cin, cout, k, d):
    g = torch.Generator().manual_seed(k * d)
    conv = torch.nn.Conv1d(cin, cout, k, dilation=d, padding=(k - 1) * d // 2)
    x = torch.randn(2, 150, cin, generator=g)
    cp = vt.conv_plan(conv, d, (k - 1) * d // 2)
    p = vt.conv_tile_plan(x.shape, cp)
    xl = F.leaky_relu(x, 0.1)
    a = _gather(xl, p.grid_m * p.bm, p.taps, p.step, -p.halo, p.cin_p, p.kp)
    got = (_x3(a, cp.wp) + F.pad(cp.b, (0, p.np - cout)))[:, :150, :cout]
    with torch.no_grad():
        ref = conv(xl.transpose(1, 2)).transpose(1, 2)
    assert _rel(got, ref) < 1e-6


@pytest.mark.parametrize("cin,cout,k,u", [(80, 40, 7, 3), (40, 20, 4, 2),
                                          (128, 64, 4, 2), (160, 80, 8, 4)])
def test_emulated_convt_matches_torch(cin, cout, k, u):
    g = torch.Generator().manual_seed(k + u)
    pad = (k - u) // 2
    convt = torch.nn.ConvTranspose1d(cin, cout, k, u, padding=pad)
    x = torch.randn(2, 61, cin, generator=g)
    tp = vt.convt_plan(convt, u, pad)
    p = vt.convt_tile_plan(x.shape, tp)
    t_out = (61 - 1) * u - 2 * pad + k
    xl = F.leaky_relu(x, 0.1)
    a = _gather(xl, p.grid_m * p.bm, p.taps, 1, -(p.taps - 1), p.cin_p, p.kp)
    got = torch.zeros(2, t_out, cout)
    for ph in range(u):
        y = _x3(a, tp.wp[ph])[..., :cout] + tp.b
        to = torch.arange(p.grid_m * p.bm) * u + ph - pad
        ok = (to >= 0) & (to < t_out)
        got[:, to[ok]] = y[:, ok]
    with torch.no_grad():
        ref = convt(xl.transpose(1, 2)).transpose(1, 2)
    assert _rel(got, ref) < 1e-6


@pytest.mark.parametrize("c,k,d,t", [(32, 11, 5, 300), (16, 3, 1, 260),
                                     (20, 5, 2, 131), (24, 7, 3, 129)])
def test_emulated_pair_matches_torch(c, k, d, t):
    """The fused ResBlock1 pair as its kernel tiles it: per CTA, conv1 over
    bm intermediate rows [t0 - halo2, t0 + bm - halo2) from a window of x,
    rows outside [0, T) set to zero before leaky and conv2, and bm_out =
    bm - (k - 1) output rows."""
    g = torch.Generator().manual_seed(c + k)
    c1 = torch.nn.Conv1d(c, c, k, dilation=d, padding=(k - 1) * d // 2)
    c2 = torch.nn.Conv1d(c, c, k, padding=(k - 1) // 2)
    p1 = vt.conv_plan(c1, d, (k - 1) * d // 2)
    p2 = vt.conv_plan(c2, 1, (k - 1) // 2)
    x = torch.randn(1, t, c, generator=g)
    p = vt.pair_plan(1, t, c, k, d)
    assert p.bm_out == p.bm - (k - 1) and p.smem <= vt.SMEM_MAX
    assert (p.grid_m - 1) * p.bm_out < t <= p.grid_m * p.bm_out
    xl = F.leaky_relu(x, 0.1)
    got = torch.zeros_like(x)
    for i in range(p.grid_m):
        t0 = i * p.bm_out
        a = _gather(xl, p.bm, k, d, t0 - p.halo2 - p.halo1, p.cin_p, p.kp1)
        z = (_x3(a, p1.wp) + F.pad(p1.b, (0, p.bn - c)))[..., : p.cin_p]
        tm = torch.arange(p.bm) + t0 - p.halo2
        z = F.leaky_relu(z, 0.1) * ((tm >= 0) & (tm < t)).float()[:, None]
        y = _x3(_gather(z, p.bm, k, 1, 0, p.cin_p, p.kp2), p2.wp)
        y = y[:, : p.bm_out, :c] + p2.b
        n = min(p.bm_out, t - t0)
        got[:, t0:t0 + n] = y[:, :n] + x[:, t0:t0 + n]
    with torch.no_grad():
        mid = c1(xl.transpose(1, 2))
        ref = c2(F.leaky_relu(mid, 0.1)).transpose(1, 2) + x
    assert _rel(got, ref) < 1e-6


def test_pair_plan_at_openvpi_stages():
    """Pairs fuse at the bytes-bound 32- and 16-channel stages; the 128-
    and 64-channel stages, bound by the products, run each pair as two conv
    launches (at 128 channels the two windows and the ring would not fit
    shared memory either)."""
    rows = {128: 27584, 64: 55168, 32: 110336, 16: 220672}
    for c, t in rows.items():
        for k, d in [(3, 1), (3, 3), (3, 5), (7, 1), (7, 3), (7, 5),
                     (11, 1), (11, 3), (11, 5)]:
            p = vt.pair_plan(1, t, c, k, d)
            assert (p is None) == (c >= 64), (c, k, d)
            if p is not None:
                assert p.bn == c and p.threads == 256
                assert p.grid_m * p.bm_out >= t


# ---------------------------------------------------------------------------
# The tail at 3xTF32 against JAX and the plain version
# ---------------------------------------------------------------------------

def _split_products(op, lo_a=True, lo_b=True):
    """``op`` (F.conv1d or F.conv_transpose1d) with both operands split by
    ``split_tf32``: a_lo b_hi + a_hi b_lo + a_hi b_hi, the small products
    first, then the bias, as the kernels add them; ``lo_a`` / ``lo_b``
    False drops the products with that lo plane."""
    def run(a, w, b, **kw):
        a_hi, a_lo = ds.split_tf32(a.contiguous())
        w_hi, w_lo = ds.split_tf32(w)
        y = op(a_hi, w_hi, None, **kw)
        small = [op(a_lo, w_hi, None, **kw)] if lo_a else []
        small += [op(a_hi, w_lo, None, **kw)] if lo_b else []
        if small:
            y = sum(small[1:], small[0]) + y
        return y + b[:, None]
    return run


PRODUCTS = {"tf32x3": (True, True), "tf32": (False, False),
            "weights' lo planes dropped": (True, False)}


def _tail_with(gen, mel, f0, randoms, route):
    lo_a, lo_b = PRODUCTS[route]
    conv = functools.partial(vt._conv_plain, products=_split_products(
        F.conv1d, lo_a, lo_b))
    convt = functools.partial(vt._convt_plain, products=_split_products(
        F.conv_transpose1d, lo_a, lo_b))
    s0 = tgen.tail_start_stage(gen.cfg)
    har = tgen.harmonic_source(gen, f0, randoms) if f0 is not None else None
    x = tgen.tail_prologue(gen, mel, har, s0)
    injs = None if har is None else [
        gen.noise_convs[i](har).transpose(1, 2).contiguous()
        for i in range(s0 + 1, len(gen.cfg.upsample_rates))]
    return vt._run(gen.tail_plan(s0), x, injs, conv, convt)


@pytest.mark.parametrize("name", list(CFGS))
def test_tf32x3_tail_matches_jax_and_plain(name):
    """The 3xTF32 tail stays within 2e-4 of the TPU tail kernel in
    interpret mode with f32 taps and within 1e-4 rel-L2 of the plain
    version; single-pass TF32 does not."""
    cfg_kw = CFGS[name]
    jcfg, params, gen = _pair(cfg_kw)
    packed = jgen.pack_params(params, jcfg, 128)
    plan, tp = jgen.build_tail_params(params, packed, jcfg, 128,
                                      weight_dtype=jnp.float32)
    mel, f0, rng = _inputs(cfg_kw)
    use_f0 = cfg_kw["use_nsf"]
    ref = np.asarray(jgen.apply_tail(tp, jcfg, mel, f0 if use_f0 else None,
                                     rng if use_f0 else None, plan=plan,
                                     ts=24, interpret=True))
    randoms = _jax_randoms(rng, 1, 20 * int(np.prod(cfg_kw["upsample_rates"])),
                           cfg_kw["harmonic_num"])
    f0_t = _t(f0) if use_f0 else None
    with torch.no_grad():
        plain = tgen.apply_serving(gen, _t(mel), f0_t, randoms).numpy()
        got = {r: _tail_with(gen, _t(mel), f0_t, randoms, r).numpy()
               for r in ("tf32x3", "tf32")}
    np.testing.assert_allclose(got["tf32x3"], ref, atol=2e-4)
    assert _rel(got["tf32x3"], plain) <= 1e-4
    assert _rel(got["tf32"], plain) > 1e-4


@pytest.mark.parametrize("route", list(PRODUCTS))
def test_tf32x3_tail_at_openvpi_width(route):
    """At config_44k's vocoder widths (4 frames, the inputs of
    ``chip_smoke.py``'s K3 check): the 3xTF32 tail within 1e-4 rel-L2 of
    the plain version (6.6e-7), single-pass TF32 (8.5e-4) and the weights'
    lo planes dropped (3.1e-4, the smoke's planted fault) beyond it.  At the
    tiny widths above the dropped lo planes read 9.2e-5, inside the limit,
    so the fault is held here."""
    torch.manual_seed(0)
    gen = tgen.Generator(tgen.HifiGanConfig(**OPENVPI)).eval()
    g = torch.Generator().manual_seed(1)
    frames = 4
    mel = torch.randn(1, frames, 128, generator=g) - 4.0
    f0 = torch.full((1, frames), 220.0)
    randoms = tgen.draw_randoms(1, frames * 512, gen.cfg.harmonic_num, g)
    with torch.no_grad():
        plain = tgen.apply_serving(gen, mel, f0, randoms)
        got = _tail_with(gen, mel, f0, randoms, route)
    assert (_rel(got, plain) <= 1e-4) == (route == "tf32x3")
