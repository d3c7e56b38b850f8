"""The tensor-core routes of K1 and K2 as far as the CPU can reach them:
the launch plans the wrappers compute for bf16 and for f32 (3xTF32):
shared memory, wgmma's tile rules, grid coverage, the C side's field order;
the K-major weight packing and, at f32, its split into hi and lo planes;
the zero padding of channels and mel bins (bit-identical through the plain
versions, and bit-exact zeros in both planes), and the ladder's workspace
(a CPU run of the per-evaluation program over the workspace and the packed
weights gives today's plain ladder bit for bit).  And the training stack's
backward (K4, K5): its plan (shared memory, row and weight grids, chunks),
the rows' positions in its transposed planes, and its transposed weight
packing with the f32 hi/lo split.  The kernels themselves run in
``test_torch_cuda.py`` (``gpu``) and ``chip_smoke.py``."""

import os
import re

import pytest
import torch
import torch.nn.functional as F

from diffsvc_tpu_torch.ops.hopper import diffnet_stack as ds
from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
from diffsvc_tpu_torch.ops.hopper import plms_ladder as pl

CSRC = os.path.join(os.path.dirname(ds.__file__), "..", "..", "csrc")
HEADER = os.path.join(CSRC, "diffnet_layer_tc.cuh")
HEADER_X3 = os.path.join(CSRC, "diffnet_layer_tf32x3.cuh")

# every config of the repo (configs/*.yaml: 256 x 80 mel at 24 kHz, 384 x
# 128 at 44.1 kHz) over the collate's frame counts, and the ragged shapes of
# the gpu tests: (B, T, C, M); M = 0 is K1 alone
SHAPES = ([(1, t, c, m) for c, m in ((256, 80), (384, 128), (256, 128),
                                      (384, 80))
           for t in range(256, 2305, 256)]
          + [(3, 77, 40, 20), (2, 70, 48, 20), (3, 1000, 384, 128),
             (3, 77, 40, 0), (1, 77, 40, 0), (1, 1024, 384, 0)])


def _header_constants(header=HEADER):
    with open(header) as f:
        src = f.read()
    consts = {k: int(v) for k, v in
              re.findall(r"constexpr int (\w+) = (\d+);", src)}
    enum = re.search(r"enum \{([^}]*)\}", src)
    fields = ([f.strip()[2:].lower() for f in enum.group(1).split(",")
               if f.strip()] if enum else None)
    return consts, fields


def test_plan_matches_the_kernels_constants():
    consts, fields = _header_constants()
    assert tuple(fields) == ds.PLAN_FIELDS
    assert (consts["BM"], consts["BN"], consts["BK"], consts["STAGES"],
            consts["THREADS"], consts["SMEM_MAX"], consts["ALIGN"]) == (
        ds.TC_BM, ds.TC_BN, ds.TC_BK, ds.TC_STAGES, ds.TC_THREADS,
        ds.SMEM_MAX, ds.TC_ALIGN)
    plan = ds.tc_plan(2, 300, 40, 20)
    assert list(plan.c_array()) == [getattr(plan, f) for f in ds.PLAN_FIELDS]


@pytest.mark.parametrize("b,t,c,m", SHAPES)
def test_plan_fits_and_covers(b, t, c, m):
    plan = ds.tc_plan(b, t, c, m)
    # wgmma: one warpgroup, M = 64, N a multiple of 8 up to 256 (and the
    # paired halves whole n8 blocks), K steps of 16 bf16 inside one
    # 128-byte swizzled row per stage
    assert plan.threads == 128 and plan.bm == 64
    assert plan.bn % 8 == 0 and plan.bn <= 256 and (plan.bn // 2) % 8 == 0
    assert plan.bk % 16 == 0 and plan.bk * 2 == 128
    assert plan.stages >= 2
    for smem in (plan.smem_layer, plan.smem_in, plan.smem_epi):
        assert smem <= ds.SMEM_MAX
    tile = plan.bm * plan.bk * 2
    assert plan.smem_layer >= plan.stages * 2 * tile + ds.TC_ALIGN
    # padding: whole K blocks, less than one block added
    assert plan.cp % plan.bk == 0 and 0 <= plan.cp - c < plan.bk
    # rows: tiles per sample cover [0, T) and no tile lies wholly past T
    assert plan.grid_m * plan.bm >= t > (plan.grid_m - 1) * plan.bm
    # columns: every channel's gate/filter (residual/skip) pair in one tile
    assert plan.grid_n_layer * (plan.bn // 2) == plan.cp
    assert plan.ctas_layer == b * plan.grid_m * plan.grid_n_layer
    if m:
        assert plan.mp % plan.bk == 0 and 0 <= plan.mp - m < plan.bk
        assert plan.grid_n_in * plan.bn == plan.cp
        assert plan.smem_in >= 2 * (plan.mp // plan.bk) * tile + ds.TC_ALIGN
        assert plan.smem_epi >= ((2 * plan.cp // plan.bk + plan.stages) * tile
                                 + ds.TC_ALIGN)
    else:
        assert plan.mp == plan.grid_n_in == plan.smem_in == plan.smem_epi == 0


def test_plan_fills_the_card_at_b1():
    """Conversion runs at B=1 with T a multiple of 256: a layer launches
    96, 144 and 192 CTAs at T = 512, 768, 1024 (C = 384)."""
    assert [ds.tc_plan(1, t, 384).ctas_layer for t in (512, 768, 1024)] == [
        96, 144, 192]


def _unpack_paired(p, c, taps):
    n_layers, _, _ = p.shape
    cp = p.shape[1] // 2
    q = p.view(n_layers, cp // ds.TC_HALF, 2, ds.TC_HALF, taps, cp)
    q = q.permute(0, 4, 5, 2, 1, 3).reshape(n_layers, taps, cp, 2, cp)
    return torch.cat([q[:, :, :c, 0, :c], q[:, :, :c, 1, :c]], -1)


@pytest.mark.parametrize("c,taps", [(40, 3), (40, 1), (384, 3), (64, 1)])
def test_pack_paired_roundtrip(c, taps):
    g = torch.Generator().manual_seed(0)
    w = torch.randn(2, taps, c, 2 * c, generator=g).to(torch.bfloat16)
    cp = ds.tc_plan(1, 64, c).cp
    p = ds.pack_paired(w, cp)
    assert p.shape == (2, 2 * cp, taps * cp) and p.is_contiguous()
    assert torch.equal(_unpack_paired(p, c, taps), w)
    assert torch.equal(ds.pack_paired(_unpack_paired(p, c, taps), cp), p)
    # row 64 i + 32 h + j is column h C + 32 i + j; column tap cp + k
    i, h, j, tap, k = 1 if cp > 32 else 0, 1, 5, taps - 1, 7
    assert p[1, 64 * i + 32 * h + j, tap * cp + k] == w[1, tap, k,
                                                        h * c + 32 * i + j]


def test_pack_kmajor_roundtrip():
    w = torch.randn(20, 40).to(torch.bfloat16)
    p = ds.pack_kmajor(w, 64, 64)
    assert p.shape == (64, 64) and torch.equal(p[:40, :20], w.t())
    assert not p[40:].any() and not p[:, 20:].any()


def _pad_channels(a, c, cp):
    """K1's operands with C zero-padded to cp as the kernels see them: the
    weights through the wrapper's packing and back."""
    def pad2(x):
        return torch.cat([F.pad(x[..., :c], (0, cp - c)),
                          F.pad(x[..., c:], (0, cp - c))], -1)

    wd = _unpack_paired(ds.pack_paired(a["wd"], cp), cp, 3)
    wo = _unpack_paired(ds.pack_paired(a["wo"][:, None], cp), cp, 1)[:, 0]
    return dict(x0=F.pad(a["x0"], (0, cp - c)), sb=F.pad(a["sb"], (0, cp - c)),
                cond_proj=pad2(a["cond_proj"]), wd=wd, bd=pad2(a["bd"]),
                wo=wo, bo=pad2(a["bo"]))


@pytest.mark.parametrize("b,t,c,layers,cycle", [(3, 77, 40, 6, 3),
                                                (2, 70, 48, 4, 4)])
def test_padded_stack_is_bit_identical(b, t, c, layers, cycle):
    from diffsvc_tpu_torch.utils.synth import stack_inputs

    a = stack_inputs(torch.bfloat16, "cpu", b, t, c, layers)
    cp = ds.tc_plan(b, t, c).cp
    ref = ds.residual_stack_plain(**a, cycle=cycle)
    got = ds.residual_stack_plain(**_pad_channels(a, c, cp), cycle=cycle)
    assert torch.equal(got[..., :c], ref)
    assert not got[..., c:].any()


def _ladder_args(b, t, c, m, layers, cycle, n_evals=5):
    from diffsvc_tpu_torch.models import diffnet
    from diffsvc_tpu_torch.models.diffusion import make_tables
    from diffsvc_tpu_torch.utils.synth import randomize

    dt = torch.bfloat16
    net = diffnet.DiffNet(m, 24, layers, c, cycle)
    randomize(net, 0)
    p = net.stacked(dt)
    ac = make_tables(100, "linear", 0.02)["alphas_cumprod"]
    t_eval, scal = pl.plms_eval_tables(ac, 100, 100 // (n_evals - 1))
    step = diffnet.step_embedding(p, torch.from_numpy(t_eval), c)
    sb = diffnet.step_bias(p, step, dt).transpose(0, 1).contiguous()
    g = torch.Generator().manual_seed(1)
    cond = torch.randn(b, t, 24, generator=g) * 0.5
    cp_ = diffnet.prepare_cond(net, cond).to(dt).contiguous()
    return dict(x_init=torch.randn(b, t, m, generator=g),
                scal=torch.from_numpy(scal), sb_tab=sb, cond_proj=cp_,
                win=p["win"], bin_=p["bin"], wskip=p["wskip"],
                bskip=p["bskip"], wout=p["wout"], bout=p["bout"],
                wd=p["wd"], bd=p["bd"], wo=p["wo"], bo=p["bo"])


def _workspace_ladder(a, cycle):
    """The per-evaluation program of dsvc_plms_ladder on the CPU: the
    workspace updated in place, the weights taken from their packed
    layouts."""
    import math

    b, t, m = a["x_init"].shape
    n_layers, c = a["cond_proj"].shape[0], a["cond_proj"].shape[3] // 2
    dt = a["win"].dtype
    plan = ds.tc_plan(b, t, c, m)
    ws = pl.ladder_workspace(a["x_init"], c, dt, plan)
    win = ds.pack_kmajor(a["win"], plan.mp, plan.cp)[:c, :m].t()
    wskip = ds.pack_kmajor(a["wskip"], plan.cp, plan.cp)[:c, :c].t()
    wout = ds.pack_kmajor(a["wout"], plan.cp, plan.mp)[:m, :c].t()
    wd = _unpack_paired(ds.pack_paired(a["wd"], plan.cp), c, 3)
    wo = _unpack_paired(ds.pack_paired(a["wo"][:, None], plan.cp), c, 1)[:, 0]
    for j in range(a["scal"].shape[0]):
        ws["xs"].copy_(torch.relu(ws["xe"].to(dt).float() @ win.float()
                                  + a["bin_"].float()).to(dt))
        sb = a["sb_tab"][j][:, None, :].expand(n_layers, b, c)
        ws["skip"].copy_(ds.residual_stack_plain(
            ws["xs"], sb, a["cond_proj"], wd, a["bd"], wo, a["bo"],
            cycle=cycle))
        sk = (ws["skip"] * (1.0 / math.sqrt(n_layers))).to(dt)
        s1 = torch.relu(sk.float() @ wskip.float()
                        + a["bskip"].float()).to(dt)
        eps = s1.float() @ wout.float() + a["bout"].float()
        x, xe, *hist = pl._update(a["scal"][j], ws["x"], ws["xe"], eps,
                                  *ws["hist"], 0.0)
        ws["x"].copy_(x)
        ws["xe"].copy_(xe)
        ws["hist"].copy_(torch.stack(hist))
    return ws["x"]


@pytest.mark.parametrize("b,t,c,m", [(2, 70, 48, 20), (1, 77, 40, 20)])
def test_ladder_workspace_path_is_bit_identical(b, t, c, m):
    a = _ladder_args(b, t, c, m, layers=4, cycle=4)
    plan = ds.tc_plan(b, t, c, m)
    ws = pl.ladder_workspace(a["x_init"], c, torch.bfloat16, plan)
    assert torch.equal(ws["x"], a["x_init"]) and torch.equal(ws["xe"],
                                                             a["x_init"])
    assert ws["x"].data_ptr() != ws["xe"].data_ptr() != a["x_init"].data_ptr()
    assert not ws["hist"].any() and ws["hist"].shape == (3, b, t, m)
    for k in ("y", "h"):
        assert ws[k].shape == (b, t, plan.cp) and not ws[k].any()
    assert tuple(pl.WORKSPACE) == ("x", "xe", "hist", "xs", "y", "h", "skip")
    ref = pl.plms_ladder_plain(**a, cycle=4)
    assert torch.equal(_workspace_ladder(a, cycle=4), ref)
    assert torch.equal(pl.plms_ladder(**a, cycle=4), ref)   # CPU: plain


def test_padded_ladder_is_bit_identical():
    """Mel bins and channels zero-padded to mp and cp through the plain
    ladder: the real bins equal the unpadded ladder's, the padded ones stay
    zero."""
    b, t, c, m = 2, 70, 40, 20
    a = _ladder_args(b, t, c, m, layers=4, cycle=4)
    plan = ds.tc_plan(b, t, c, m)
    cp, mp = plan.cp, plan.mp
    k1 = _pad_channels(dict(x0=torch.zeros(b, t, c, dtype=torch.bfloat16),
                            sb=a["sb_tab"].transpose(0, 1), **{
                                k: a[k] for k in ("cond_proj", "wd", "bd",
                                                  "wo", "bo")}), c, cp)
    pad = dict(a, x_init=F.pad(a["x_init"], (0, mp - m)),
               sb_tab=k1["sb"].transpose(0, 1).contiguous(),
               cond_proj=k1["cond_proj"], wd=k1["wd"], bd=k1["bd"],
               wo=k1["wo"], bo=k1["bo"],
               win=F.pad(a["win"], (0, cp - c, 0, mp - m)),
               bin_=F.pad(a["bin_"], (0, cp - c)),
               wskip=F.pad(a["wskip"], (0, cp - c, 0, cp - c)),
               bskip=F.pad(a["bskip"], (0, cp - c)),
               wout=F.pad(a["wout"], (0, mp - m, 0, cp - c)),
               bout=F.pad(a["bout"], (0, mp - m)))
    ref = pl.plms_ladder_plain(**a, cycle=4)
    got = pl.plms_ladder_plain(**pad, cycle=4)
    assert torch.equal(got[..., :m], ref) and not got[..., m:].any()


# ---------------------------------------------------------------------------
# f32: the 3xTF32 route
# ---------------------------------------------------------------------------

def test_f32_plan_matches_the_kernels_constants():
    """The f32 kernels (namespace tf32x3) read the same plan fields
    (tc::P_*) with their own tiles: 32 f32 per 128-byte row, 3 stages."""
    consts, fields = _header_constants(HEADER_X3)
    assert fields is None       # the fields are diffnet_layer_tc.cuh's
    assert (consts["BM"], consts["BN"], consts["BK"], consts["STAGES"],
            consts["THREADS"], consts["SMEM_MAX"], consts["ALIGN"]) == (
        ds.TC_BM, ds.TC_BN, ds.X3_BK, ds.X3_STAGES, ds.TC_THREADS,
        ds.SMEM_MAX, ds.TC_ALIGN)
    plan = ds.tc_plan(2, 300, 40, 20, torch.float32)
    assert list(plan.c_array()) == [getattr(plan, f) for f in ds.PLAN_FIELDS]


@pytest.mark.parametrize("b,t,c,m", SHAPES)
def test_f32_plan_fits_and_covers(b, t, c, m):
    plan = ds.tc_plan(b, t, c, m, torch.float32)
    # wgmma at TF32: one warpgroup, M = 64, N = 64 (paired halves whole n8
    # blocks), K steps of 8 f32 inside one 128-byte swizzled row per stage
    assert plan.threads == 128 and plan.bm == 64 and plan.bn == 64
    assert plan.bk % 8 == 0 and plan.bk * 4 == 128
    tile = plan.bm * plan.bk * 4
    # a stage holds A hi, A lo, B hi, B lo; a ring of >= 3 stages loads two
    # K blocks ahead
    assert plan.stages >= 3
    assert plan.smem_layer >= plan.stages * 4 * tile + ds.TC_ALIGN
    for smem in (plan.smem_layer, plan.smem_in, plan.smem_epi):
        assert smem <= ds.SMEM_MAX
    # two CTAs share an SM (228 KB, 1 KB reserved per CTA)
    assert 2 * (plan.smem_layer + 1024) <= 228 * 1024
    # padding: whole 64-wide N tiles (K1's pairs, the projections), less
    # than one tile added, and whole K blocks
    assert plan.cp % plan.bn == 0 and 0 <= plan.cp - c < plan.bn
    assert plan.cp % plan.bk == 0
    assert plan.grid_m * plan.bm >= t > (plan.grid_m - 1) * plan.bm
    assert plan.grid_n_layer * (plan.bn // 2) == plan.cp
    assert plan.ctas_layer == b * plan.grid_m * plan.grid_n_layer
    if m:
        assert plan.mp % plan.bn == 0 and 0 <= plan.mp - m < plan.bn
        assert plan.grid_n_in * plan.bn == plan.cp
        # the input projection keeps A and B resident, hi and lo planes
        assert plan.smem_in >= 4 * (plan.mp // plan.bk) * tile + ds.TC_ALIGN
        # the skip and output projections stream through the layers' ring
        assert plan.smem_epi >= plan.stages * 4 * tile + ds.TC_ALIGN
    else:
        assert plan.mp == plan.grid_n_in == plan.smem_in == plan.smem_epi == 0


def test_f32_plan_fills_the_card_at_b1():
    """At B=1 and C=384 an f32 layer launches as many CTAs as a bf16 one:
    96, 144 and 192 at T = 512, 768, 1024, two per SM, one wave on 132
    SMs."""
    plans = [ds.tc_plan(1, t, 384, 128, torch.float32) for t in (512, 768,
                                                                 1024)]
    assert [p.ctas_layer for p in plans] == [96, 144, 192]
    assert all(p.ctas_layer <= 2 * 132 for p in plans)


@pytest.mark.parametrize("c,taps", [(40, 3), (40, 1), (384, 3), (64, 1)])
def test_pack_split_roundtrip(c, taps):
    """K1's f32 weights packed as the kernels read them: a hi and a lo
    plane of the paired K-major layout, hi + lo within 2^-22 of each
    weight, both planes exact TF32 values, and the padding bit-exact +0 in
    both planes."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(2, taps, c, 2 * c, generator=g) / 10
    cp = ds.tc_plan(1, 64, c, dtype=torch.float32).cp
    wd, wo = ds.pack_layers(w if taps == 3 else torch.zeros(2, 3, c, 2 * c),
                            w[:, 0], cp)
    p = wd if taps == 3 else wo
    assert p.shape == (2, 2, 2 * cp, taps * cp) and p.is_contiguous()
    hi, lo = p[:, 0], p[:, 1]
    paired = ds.pack_paired(w, cp)
    assert torch.equal(hi, ds.split_tf32(paired)[0])
    assert torch.equal(lo, ds.split_tf32(paired)[1])
    for plane in (hi, lo):
        assert not (plane.view(torch.int32) & 0x1FFF).any()
    back = _unpack_paired(hi, c, taps).double() + _unpack_paired(lo, c,
                                                                 taps).double()
    assert ((back - w.double()).abs() <= 2.0 ** -22 * w.double().abs()).all()
    # the padding: every element that holds no weight is +0.0 in both planes
    real = ds.pack_paired(torch.ones_like(w), cp) != 0
    for plane in (hi, lo):
        assert not plane.view(torch.int32)[~real].any()


def test_pack_split_projections():
    """K2's f32 projections: K-major, zero padded, then split: [2, N, K]."""
    w = torch.randn(20, 40) / 10
    p = ds.pack_split(ds.pack_kmajor(w, 64, 64))
    assert p.shape == (2, 64, 64)
    assert torch.equal(p[0, :40, :20], ds.split_tf32(w.t())[0])
    assert torch.equal(p[1, :40, :20], ds.split_tf32(w.t())[1])
    assert not p[:, 40:].view(torch.int32).any()
    assert not p[:, :, 20:].view(torch.int32).any()


@pytest.mark.parametrize("b,t,c,m", [(2, 70, 48, 20), (1, 1024, 384, 128)])
def test_f32_workspace(b, t, c, m):
    """The f32 ladder's workspace: the sampler state as at bf16, K1's state
    and skip sum in f32, and y and h as hi and lo planes [2, B, T, cp] of
    zeros."""
    plan = ds.tc_plan(b, t, c, m, torch.float32)
    x = torch.randn(b, t, m)
    ws = pl.ladder_workspace(x, c, torch.float32, plan)
    assert torch.equal(ws["x"], x) and torch.equal(ws["xe"], x)
    assert ws["xs"].shape == ws["skip"].shape == (b, t, c)
    for k in ("y", "h"):
        assert ws[k].shape == (2, b, t, plan.cp)
        assert ws[k].dtype == torch.float32 and not ws[k].any()
    assert ws["y"].data_ptr() != ws["h"].data_ptr()


# ---------------------------------------------------------------------------
# The training stack's backward (K4, K5): its plan, chunk positions and
# transposed weight packing
# ---------------------------------------------------------------------------

HEADER_TRAIN = os.path.join(CSRC, "diffnet_train_bwd.cuh")

# K4's check and training batches (B=24, T=1024; the gpu tests' ragged
# shapes) and K5's (B=32 at T=1024; config_44k's own 88 x 768; T > 2048):
# (B, T, C, seg_rows)
TRAIN_SHAPES = [(24, 1024, 384, 24 * 1024), (3, 1000, 384, 3000),
                (2, 77, 40, 154), (3, 77, 40, 231), (1, 64, 384, 64),
                (32, 1024, 384, 1024), (88, 768, 384, 768),
                (3, 1000, 384, 1000), (2, 2100, 40, 2100), (3, 77, 40, 77)]


def _mode_constants(src, mode):
    body = re.search(r"struct %s \{([^}]*)\}" % mode, src).group(1)
    return {k: int(v) for k, v in re.findall(r"(\w+) = (\d+)", body)}


def test_train_plan_matches_the_kernels_constants():
    """The backward's plan fields (enum Q_*), tiles and modes as
    csrc/diffnet_train_bwd.cuh declares them."""
    consts, fields = _header_constants(HEADER_TRAIN)
    assert tuple(fields) == k4.TRAIN_PLAN_FIELDS
    assert (consts["BM"], consts["BN"], consts["THREADS"], consts["KC_ALIGN"],
            consts["SMEM_MAX"], consts["WG_WGS"], consts["WG_NB"]) == (
        64, 64, ds.TC_THREADS, k4.KC_ALIGN, ds.SMEM_MAX, k4.WG_WGS, k4.WG_NB)
    with open(HEADER_TRAIN) as f:
        src = f.read()
    for mode, dtype in (("Bf16", torch.bfloat16), ("Tf32x3", torch.float32)):
        m = _mode_constants(src, mode)
        plan = k4.train_plan(2, 300, 40, 600, dtype)
        assert (m["P"], m["BK"], m["STAGES"]) == (plan.planes, plan.bk,
                                                  plan.stages)
        assert m["BK"] * (2 if dtype == torch.bfloat16 else 4) == 128
        assert m["EPC"] * (2 if dtype == torch.bfloat16 else 4) == 16
        assert plan.mode == ds._DTYPES[dtype]
        assert list(plan.c_array()) == [getattr(plan, f)
                                        for f in k4.TRAIN_PLAN_FIELDS]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,t,c,seg", TRAIN_SHAPES)
def test_train_plan_fits_and_covers(b, t, c, seg, dtype):
    """Shared memory within 227 KB (two row-tiled CTAs an SM at f32); the
    row grids cover each sample's T rows and the B*T rows; the weight grids'
    128 x 128 tiles cover [C, 2C] (dWo) and [3C, 2C] (dW_j), no tile wholly
    past the padded channels; the chunk count and padded length cover every
    segment."""
    plan = k4.train_plan(b, t, c, seg, dtype)
    tile = 64 * 128
    assert plan.threads == 128
    assert plan.smem >= plan.stages * 2 * plan.planes * tile + ds.TC_ALIGN
    assert plan.smem_w >= plan.stages * plan.planes * (
        k4.WG_WGS * tile + k4.WG_NB * 128) + ds.TC_ALIGN
    assert max(plan.smem, plan.smem_w) <= ds.SMEM_MAX
    if dtype == torch.float32:
        assert 2 * (plan.smem + 1024) <= 228 * 1024
    assert plan.cp % 64 == 0 and 0 <= plan.cp - c < 64
    assert plan.grid_t * 64 >= t > (plan.grid_t - 1) * 64
    assert plan.grid_r * 64 >= b * t > (plan.grid_r - 1) * 64
    assert plan.grid_c * 64 == plan.cp and plan.grid_pair * 32 == plan.cp
    wm = k4.WG_WGS * 64
    for grid, rows in ((plan.grid_wo, plan.cp), (plan.grid_wd, 3 * plan.cp),
                       (plan.grid_wn, 2 * plan.cp)):
        assert grid * wm >= rows > (grid - 1) * wm
    nseg = b * t // seg
    assert plan.cps * k4.RCH >= seg > (plan.cps - 1) * k4.RCH
    assert plan.nchunk == nseg * plan.cps and plan.rp == plan.nchunk * plan.kc
    assert plan.kc % plan.bk == 0 and plan.kc % k4.KC_ALIGN == 0
    assert min(seg, k4.RCH) <= plan.kc < min(seg, k4.RCH) + k4.KC_ALIGN


def test_train_plan_rejects_a_ragged_segment():
    with pytest.raises(ValueError):
        k4.train_plan(3, 100, 40, 200, torch.float32)


@pytest.mark.parametrize("b,t,c,seg", TRAIN_SHAPES)
def test_chunk_positions(b, t, c, seg):
    """Every row has its own position; the chunks start at each segment's
    first row (K4: one segment; K5: each sample) and hold at most RCH rows
    in order, each inside its own kc positions; a sample's positions in a
    batch are those of its B=1 run shifted by whole chunks."""
    plan = k4.train_plan(b, t, c, seg, torch.float32)
    pos = k4.chunk_positions(b, t, seg, plan.kc)
    assert pos.shape == (b * t,) and len(set(pos.tolist())) == b * t
    assert int(pos.min()) >= 0 and int(pos.max()) < plan.rp
    r = torch.arange(b * t)
    within = r % seg
    chunk = (r // seg) * plan.cps + within // k4.RCH
    assert torch.equal(pos // plan.kc, chunk)
    assert torch.equal(pos % plan.kc, within % k4.RCH)
    assert (pos[r % seg == 0] % plan.kc == 0).all()
    if seg == t:
        one = k4.chunk_positions(1, t, t, plan.kc)
        for i in range(b):
            assert torch.equal(pos[i * t:(i + 1) * t],
                               one + i * plan.cps * plan.kc)


@pytest.mark.parametrize("c", [40, 64, 384])
def test_pack_dh_roundtrip(c):
    """dh's B: row o of [cp, 2cp] holds wo[o] with each half of its 2C
    columns at h cp + k, zero padded; the product over the padded do
    layout is wo's."""
    g = torch.Generator().manual_seed(0)
    wo = torch.randn(2, c, 2 * c, generator=g)
    cp = k4.train_plan(1, 64, c, 64, torch.float32).cp
    p = k4.pack_dh(wo, cp)
    assert p.shape == (2, cp, 2 * cp) and p.is_contiguous()
    back = torch.cat([p[:, :c, :c], p[:, :c, cp:cp + c]], -1)
    assert torch.equal(back, wo)
    real = k4.pack_dh(torch.ones_like(wo), cp) != 0
    assert not p[~real].any() and int(real.sum()) == wo.numel()
    do = torch.randn(5, 2 * c, generator=g).double()
    do_p = torch.cat([F.pad(do[:, :c], (0, cp - c)),
                      F.pad(do[:, c:], (0, cp - c))], -1)
    want = do @ wo[1].double().t()
    assert torch.allclose((do_p @ p[1].double().t())[:, :c], want)


@pytest.mark.parametrize("c", [40, 64, 384])
def test_pack_dy_roundtrip(c):
    """dy's B: row o of [cp, 6cp] holds tap j's row o of wd at columns j 2cp
    + h cp + k (column h C + k of W_j), zero padded."""
    g = torch.Generator().manual_seed(1)
    wd = torch.randn(2, 3, c, 2 * c, generator=g)
    cp = k4.train_plan(1, 64, c, 64, torch.float32).cp
    p = k4.pack_dy(wd, cp)
    assert p.shape == (2, cp, 6 * cp) and p.is_contiguous()
    q = p.view(2, cp, 3, 2, cp)
    back = torch.cat([q[:, :c, :, 0, :c], q[:, :c, :, 1, :c]], -1)
    assert torch.equal(back.permute(0, 2, 1, 3), wd)
    real = k4.pack_dy(torch.ones_like(wd), cp) != 0
    assert not p[~real].any() and int(real.sum()) == wd.numel()
    # tap j, output channel 5, column C + 7 of W_j
    assert p[1, 5, 2 * 2 * cp + cp + 7] == wd[1, 2, 5, c + 7]


@pytest.mark.parametrize("c", [40, 384])
def test_pack_bwd_planes(c):
    """At f32 each of the backward's packed weights is a hi and a lo plane
    of its K-major layout (exact TF32 values, hi + lo within 2^-22 of each
    weight, padding +0 in both); at bf16 one plane, unsplit."""
    g = torch.Generator().manual_seed(2)
    wd = torch.randn(2, 3, c, 2 * c, generator=g) / 10
    wo = torch.randn(2, c, 2 * c, generator=g) / 10
    cp = k4.train_plan(1, 64, c, 64, torch.float32).cp
    plain = (ds.pack_paired(wd, cp), k4.pack_dh(wo, cp), k4.pack_dy(wd, cp))
    for p, w in zip(k4.pack_bwd(wd, wo, cp), plain):
        assert p.shape == (2, 2, *w.shape[1:]) and p.is_contiguous()
        hi, lo = p[:, 0], p[:, 1]
        for plane in (hi, lo):
            assert not (plane.view(torch.int32) & 0x1FFF).any()
        err = (hi.double() + lo.double() - w.double()).abs()
        assert (err <= 2.0 ** -22 * w.double().abs()).all()
        assert not hi.view(torch.int32)[w == 0].any()
        assert not lo.view(torch.int32)[w == 0].any()
    bf = k4.pack_bwd(wd.bfloat16(), wo.bfloat16(), cp)
    for p, w in zip(bf, plain):
        assert p.dtype == torch.bfloat16 and torch.equal(p, w.bfloat16())


def test_operand_planes_are_zero():
    """The backward's per-layer operand planes: shapes by the plan, zeros
    (their pad channels and positions are never written)."""
    b, t, c = 3, 77, 40
    for dtype in (torch.bfloat16, torch.float32):
        plan = k4.train_plan(b, t, c, b * t, dtype)
        planes = k4.operand_planes(b * t, plan, dtype, "cpu")
        cp, rp, p = plan.cp, plan.rp, plan.planes
        assert [tuple(x.shape) for x in planes] == [
            (p, b * t, cp), (p, 3 * cp, rp), (p, cp, rp), (p, b * t, 2 * cp),
            (p, 2 * cp, rp), (p, b * t, 2 * cp), (p, 2 * cp, rp)]
        assert all(x.dtype == dtype and not x.any() for x in planes)
