"""The port's other vocoder families and their training modules against the
JAX package on the CPU: the inverse STFT, the iSTFT head (f32 and the bf16
backbone, ``.npz`` checkpoints read both ways, its wrapper), PWG (the
generator, both discriminators, the official-layout wrapper with
``loud_norm``), MelGAN (causal and not) and its discriminators, HiFi-GAN's
MPD and MSD with the weight- and spectral-norm reparameterizations and the
GAN losses, the multi-resolution STFT loss, PQMF and the cyclic-noise
source on the same draws.

The same numpy inputs from a seed go through both; weights are JAX's,
carried by ``utils/convert`` (PWG's and the MelGAN discriminators' go the
other way, through the JAX package's own converters).  Tolerances (stated
per test): f32 modules 1e-5 relative to the output's scale (convolution
sums in another order), the bf16 backbone 2e-2 (roundings of bf16
activations flip), losses 1e-5 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffsvc_tpu.ops import stft_loss as jstft
from diffsvc_tpu.ops.istft import istft as jistft
from diffsvc_tpu.vocoders import discriminators as jD
from diffsvc_tpu.vocoders import hifigan as jhifigan
from diffsvc_tpu.vocoders import istft_head as jih
from diffsvc_tpu.vocoders import melgan as jmelgan
from diffsvc_tpu.vocoders import pqmf as jpqmf
from diffsvc_tpu.vocoders import pwg as jpwg
from diffsvc_tpu.vocoders import source as jsource
from diffsvc_tpu_torch.ops import stft_loss as tstft
from diffsvc_tpu_torch.ops.istft import istft as tistft
from diffsvc_tpu_torch.utils import convert
from diffsvc_tpu_torch.vocoders import discriminators as tD
from diffsvc_tpu_torch.vocoders import hifigan as thifigan
from diffsvc_tpu_torch.vocoders import istft_head as tih
from diffsvc_tpu_torch.vocoders import melgan as tmelgan
from diffsvc_tpu_torch.vocoders import pqmf as tpqmf
from diffsvc_tpu_torch.vocoders import pwg as tpwg
from diffsvc_tpu_torch.vocoders import source as tsource
from diffsvc_tpu_torch.vocoders.base import get_vocoder_cls
from test_torch_parallel import _mesh, fused_sides  # noqa: F401 (fixture)


# JAX's discriminators compiled once for the module's tests
_J_MPD, _J_MSD = jax.jit(jD.apply_mpd), jax.jit(jD.apply_msd)


def _close(got, ref, rel):
    """max |got - ref| within ``rel`` of ref's largest magnitude."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(np.abs(ref).max(), 1e-12)
    assert np.abs(got - ref).max() <= rel * scale, (
        np.abs(got - ref).max(), scale)


def _rel_l2(got, ref):
    """||got - ref|| / ||ref|| in float64 (same shapes)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


# ------------------------------------------------------------------ istft --

@pytest.mark.parametrize("geo", [(2048, 512), (512, 128)], ids=["44k", "24k"])
def test_istft_matches_jax(geo):
    """A batch of random spectra (the port's op takes leading dims; JAX's
    one spectrum): within 1e-5 of the output's scale."""
    n_fft, hop = geo
    rng = np.random.RandomState(0)
    re, im = (rng.randn(2, 13, n_fft // 2 + 1).astype(np.float32)
              for _ in range(2))
    got = tistft(_t(re), _t(im), n_fft=n_fft, hop=hop, length=13 * hop)
    ref = [np.asarray(jistft(jnp.asarray(re[i]), jnp.asarray(im[i]),
                             n_fft=n_fft, hop=hop, length=13 * hop))
           for i in range(2)]
    _close(got.numpy(), np.stack(ref), 1e-5)


# ------------------------------------------------------------ iSTFT head --

ICFG = dict(num_mels=16, dim=32, n_layers=2, n_fft=256, hop=64,
            sampling_rate=8000, use_f0=True)


def _istft_pair(seed=0):
    jcfg = jih.IstftVocoderConfig(**ICFG)
    jp = jih.init(jax.random.PRNGKey(seed), jcfg)
    # layer norms and gammas off their init, so every leaf matters
    r = np.random.RandomState(seed)
    jp = jax.tree_util.tree_map(
        lambda a: a + 0.1 * r.randn(*a.shape).astype(np.float32), jp)
    head = tih.IstftHead(tih.IstftVocoderConfig(**ICFG))
    convert.load_reference_state(head, convert.istft_jax_to_torch(jp))
    return jcfg, jp, head


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_istft_head_matches_jax(dtype):
    """log10-mel + f0 -> wav: f32 within 1e-5 of the output's scale; the
    bf16 backbone (its LayerNorms, the head and the iSTFT f32) within
    2e-2, and it must differ from f32 (the backbone did run in bf16)."""
    jcfg, jp, head = _istft_pair()
    rng = np.random.RandomState(1)
    mel = (rng.randn(2, 20, 16) - 4).astype(np.float32)
    f0 = np.where(rng.rand(2, 20) < 0.2, 0.0, 180 + 200 * rng.rand(2, 20)
                  ).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bf16" else None
    tdt = torch.bfloat16 if dtype == "bf16" else None
    ref = np.asarray(jih.apply(jp, jcfg, jnp.asarray(mel), jnp.asarray(f0),
                               dtype=jdt))
    with torch.no_grad():
        got = tih.apply(head, _t(mel), _t(f0), dtype=tdt).numpy()
    assert got.shape == (2, 20 * 64) and np.abs(ref).max() > 1e-3
    _close(got, ref, 2e-2 if dtype == "bf16" else 1e-5)
    if dtype == "bf16":
        with torch.no_grad():
            f32 = tih.apply(head, _t(mel), _t(f0)).numpy()
        assert np.abs(f32 - got).max() > 1e-6


def test_istft_npz_reads_both_ways(tmp_path):
    """JAX's save_params file loads into the port, and the port's into
    JAX's load_params, leaf for leaf equal; the registry wrapper
    (``IstftVocoder`` / ``istftvocoder``) vocodes from the file as JAX's
    does (1e-5)."""
    jcfg, jp, head = _istft_pair(3)
    jfile = str(tmp_path / "jax.npz")
    jih.save_params(jfile, jp)
    loaded = tih.load_params(jfile, tih.IstftVocoderConfig(**ICFG))
    for k, v in head.state_dict().items():
        assert torch.equal(loaded.state_dict()[k], v), k
    tfile = str(tmp_path / "port.npz")
    tih.save_params(tfile, head)
    back = jih.load_params(tfile, jcfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    hp = dict(audio_num_mel_bins=16, istft_dim=32, istft_layers=2,
              fft_size=256, hop_size=64, win_size=256, audio_sample_rate=8000,
              fmin=40, fmax=4000, use_nsf=True, vocoder="IstftVocoder",
              vocoder_ckpt=tfile)
    for name in ("IstftVocoder", "istftvocoder",
                 "diffsvc_tpu.vocoders.istft_head.IstftVocoder"):
        assert get_vocoder_cls(dict(hp, vocoder=name)) is tih.IstftVocoder
    mel = (np.random.RandomState(2).randn(12, 16) - 4).astype(np.float32)
    f0 = np.full(12, 220.0, np.float32)
    got = tih.IstftVocoder(hp).spec2wav(mel, f0=f0)
    ref = jih.IstftVocoder(hp).spec2wav(mel, f0=f0)
    _close(got, ref, 1e-5)


# -------------------------------------------------------------------- PWG --

PCFG = tpwg.PWGConfig(layers=6, stacks=2, residual_channels=8,
                      gate_channels=16, skip_channels=8, aux_channels=16,
                      aux_context_window=2, upsample_scales=(4, 2, 2, 2))


def _pwg_jcfg(cfg):
    return jpwg.PWGConfig(**cfg._asdict())


def test_pwg_generator_matches_jax():
    """The port's state dict through JAX's ``pwg.convert``: the same wav
    from the same z and edge-padded mel (1e-5)."""
    torch.manual_seed(0)
    gen = tpwg.ParallelWaveGANGenerator(PCFG)
    sd = {k: v.numpy() for k, v in gen.state_dict().items()}
    jp = jpwg.convert(sd, _pwg_jcfg(PCFG))
    rng = np.random.RandomState(0)
    mel = rng.randn(1, 10 + 4, 16).astype(np.float32)
    z = rng.randn(1, 10 * 32).astype(np.float32)
    with torch.no_grad():
        got = gen(_t(z), _t(mel)).numpy()
    ref = np.asarray(jpwg.apply(jp, _pwg_jcfg(PCFG), jnp.asarray(z),
                                jnp.asarray(mel)))
    _close(got, ref, 1e-5)


@pytest.mark.parametrize("kind", ["plain", "dilation_factor", "residual"])
def test_pwg_discriminators_match_jax(kind):
    """ParallelWaveGANDiscriminator (dilation i, or factor^i) and the
    residual one through JAX's converters: the score map within 1e-5."""
    torch.manual_seed(1)
    if kind == "residual":
        cfg = tpwg.ResidualPWGDiscriminatorConfig(
            layers=4, stacks=2, residual_channels=8, gate_channels=16,
            skip_channels=8)
        disc = tpwg.ResidualParallelWaveGANDiscriminator(cfg)
        jcfg = jpwg.ResidualPWGDiscriminatorConfig(**cfg._asdict())
        conv, app = (jpwg.convert_residual_discriminator,
                     jpwg.apply_residual_discriminator)
    else:
        cfg = tpwg.PWGDiscriminatorConfig(
            layers=5, conv_channels=8,
            dilation_factor=2 if kind == "dilation_factor" else 1)
        disc = tpwg.ParallelWaveGANDiscriminator(cfg)
        jcfg = jpwg.PWGDiscriminatorConfig(**cfg._asdict())
        conv, app = jpwg.convert_discriminator, jpwg.apply_discriminator
    sd = {k: v.numpy() for k, v in disc.state_dict().items()}
    wav = np.random.RandomState(2).randn(2, 300).astype(np.float32) * 0.3
    with torch.no_grad():
        got = disc(_t(wav)).numpy().transpose(0, 2, 1)
    ref = np.asarray(app(conv(sd, jcfg), jcfg, jnp.asarray(wav)))
    _close(got, ref, 1e-5)


def _write_pwg_dir(d, seed=1):
    """An official PWG directory: config.yaml, checkpoint-400000steps.pkl
    with weight-normed convs, stats.npy."""
    from diffsvc_tpu_torch.utils import synth

    return synth.write_pwg(d, dict(
        layers=6, stacks=2, residual_channels=8, gate_channels=16,
        skip_channels=8, aux_channels=16, aux_context_window=2,
        upsample_params={"upsample_scales": [4, 2, 2, 2]}), hop_size=32,
        seed=seed)


def test_pwg_wrapper_matches_jax(tmp_path):
    """``PWG`` from an official directory (weight norm folded, the
    StandardScaler's stats.npy): registered under its name and the
    reference's dotted one; spec2wav of one mel and seed equals JAX's
    wrapper (1e-5), another seed gives another wav."""
    d = str(tmp_path / "pwg")
    _write_pwg_dir(d)
    hp = dict(vocoder="network.vocoders.pwg.PWG", vocoder_ckpt=d,
              hop_size=32, audio_sample_rate=8000)
    assert get_vocoder_cls(hp) is thifigan.PWG
    assert get_vocoder_cls(dict(hp, vocoder="pwg")) is thifigan.PWG
    tv, jv = thifigan.PWG(hp), jhifigan.PWG(hp)
    np.testing.assert_array_equal(tv.impl.scaler_mean, jv.impl.scaler_mean)
    mel = (np.random.RandomState(4).randn(9, 16) - 3).astype(np.float32)
    got = tv.spec2wav(mel, seed=5)
    ref = jv.spec2wav(mel, seed=5)
    assert got.shape == (9 * 32,) and np.abs(ref).max() > 1e-4
    _close(got, ref, 1e-5)
    assert np.abs(tv.spec2wav(mel, seed=6) - got).max() > 1e-4


def test_pwg_reference_trainer_ckpt_loads(tmp_path):
    """A reference-trainer ``model_ckpt_steps_*.ckpt`` (``model_gen.``
    keys, no stats) takes precedence and vocodes as JAX's wrapper does."""
    d = tmp_path / "pwg"
    gen = _write_pwg_dir(str(d), seed=2)
    torch.save({"state_dict": {f"model_gen.{k}": v for k, v in
                               gen.state_dict().items()}},
               str(d / "model_ckpt_steps_7.ckpt"))
    hp = dict(vocoder="PWG", vocoder_ckpt=str(d), hop_size=32)
    tv, jv = thifigan.PWG(hp), jhifigan.PWG(hp)
    assert tv.impl.scaler_mean is None
    mel = (np.random.RandomState(5).randn(7, 16) - 3).astype(np.float32)
    _close(tv.spec2wav(mel), jv.spec2wav(mel), 1e-5)


# ----------------------------------------------------------------- MelGAN --

@pytest.mark.parametrize("causal", [False, True], ids=["plain", "causal"])
def test_melgan_generator_matches_jax(causal):
    """JAX params through ``convert.melgan_jax_to_torch``: the same wav
    (1e-5); causal: reflection on the left, each ConvT's last r samples
    dropped."""
    cfg = jmelgan.MelGANConfig(in_channels=6, channels=16,
                               upsample_scales=(4, 2), stacks=2,
                               use_causal_conv=causal)
    jp = jmelgan.init(jax.random.PRNGKey(0), cfg)
    gen = tmelgan.MelGANGenerator(tmelgan.MelGANConfig(**cfg._asdict()))
    convert.load_reference_state(gen, convert.melgan_jax_to_torch(jp))
    mel = np.random.RandomState(0).randn(2, 11, 6).astype(np.float32)
    with torch.no_grad():
        got = gen(_t(mel)).numpy()
    ref = np.asarray(jax.jit(lambda p, m: jmelgan.apply(p, cfg, m))(
        jp, jnp.asarray(mel)))
    assert got.shape == (2, 11 * 8)
    _close(got, ref, 1e-5)


def test_melgan_discriminators_match_jax():
    """MelGANDiscriminator and the multi-scale one: JAX params through
    ``convert.melgan_discriminator_jax_to_torch``, and the port's state
    dict back through JAX's converters; every layer's output within 1e-5
    (the pooling between scales leaves the padding out of the count)."""
    cfg = jmelgan.MelGANDiscriminatorConfig(
        channels=4, max_downsample_channels=32, downsample_scales=(4, 2),
        scales=3)
    tcfg = tmelgan.MelGANDiscriminatorConfig(**cfg._asdict())
    jp = jmelgan.init_multiscale_discriminator(jax.random.PRNGKey(1), cfg)
    msd = tmelgan.MelGANMultiScaleDiscriminator(tcfg)
    convert.load_reference_state(
        msd, convert.melgan_discriminator_jax_to_torch(jp))
    wav = np.random.RandomState(3).randn(2, 203).astype(np.float32) * 0.5
    with torch.no_grad():
        got = msd(_t(wav))
    ref = jmelgan.apply_multiscale_discriminator(jp, cfg, jnp.asarray(wav))
    assert len(got) == len(ref) == 3
    for g_scale, r_scale in zip(got, ref):
        for g, r in zip(g_scale, r_scale):
            _close(g.numpy().transpose(0, 2, 1), np.asarray(r), 1e-5)
    sd = {k: v.numpy() for k, v in msd.state_dict().items()}
    back = jmelgan.convert_multiscale_discriminator(sd, cfg)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------- MPD, MSD and the GAN losses --

def _disc_tree(mod):
    """MPD / MSD module -> JAX's tree (the inverse of
    ``convert.hifigan_discriminator_jax_to_torch``)."""
    def leaf(c):
        out = {"b": c.bias.detach().numpy()}
        if isinstance(c, tD.WNConv1d):
            out.update(v=c.weight_v.detach().numpy().transpose(2, 1, 0),
                       g=c.weight_g.detach().numpy())
        else:
            out["w_bar"] = c.weight_bar.detach().numpy().transpose(2, 1, 0)
        return out
    return [{"convs": [leaf(c) for c in d.convs],
             "conv_post": leaf(d.conv_post)} for d in mod.discriminators]


@pytest.fixture(scope="module")
def hifigan_discs():
    """Full-width MPD and MSD (the JAX modules have no width option) with
    every leaf moved by 5% N(0, 1) of itself (weight norm's g off ||v||),
    their JAX trees, and two waveforms of 131 samples (every period
    pads)."""
    torch.manual_seed(0)
    mpd, msd = tD.MultiPeriodDiscriminator(), tD.MultiScaleDiscriminator()
    with torch.no_grad():
        for p in list(mpd.parameters()) + list(msd.parameters()):
            p.mul_(1 + 0.05 * torch.randn_like(p))
    jmpd, jmsd = _disc_tree(mpd), _disc_tree(msd)
    for mod, tree in ((mpd, jmpd), (msd, jmsd)):
        sd = convert.hifigan_discriminator_jax_to_torch(tree)
        for k, v in mod.state_dict().items():
            assert torch.equal(sd[k], v), k
    rng = np.random.RandomState(2)
    y = (rng.randn(2, 131) * 0.3).astype(np.float32)
    y_hat = (rng.randn(2, 131) * 0.3).astype(np.float32)
    return jmpd, jmsd, mpd, msd, y, y_hat


@pytest.mark.parametrize("which", ["mpd", "msd"])
def test_hifigan_discriminators_match_jax(hifigan_discs, which):
    """Scores and feature maps of both waveforms (1e-5 of each map's
    scale): MPD folds each period (reflect-padded to a multiple), MSD's
    first scale is spectrally normalized (5 stateless power iterations).
    The weights go through ``convert.hifigan_discriminator_jax_to_torch``
    (the fixture holds it)."""
    jmpd, jmsd, mpd, msd, y, y_hat = hifigan_discs
    japply, jp, mod = ((_J_MPD, jmpd, mpd) if which == "mpd"
                       else (_J_MSD, jmsd, msd))
    ref = japply(jp, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        got = mod(_t(y), _t(y_hat))
    for g_list, r_list in zip(got[:2], ref[:2]):          # scores
        for g, r in zip(g_list, r_list):
            _close(g.numpy(), np.asarray(r), 1e-5)
    for g_maps, r_maps in zip(got[2] + got[3], ref[2] + ref[3]):
        for g, r in zip(g_maps, r_maps):
            _close(g.numpy().transpose(0, 2, 1), np.asarray(r), 1e-5)


def test_reparameterized_weights_match_jax(hifigan_discs):
    """``wn_weight`` (the norm per output channel over (k, in), +1e-12) and
    ``sn_weight`` (5 iterations from u = 1/sqrt(co)), weight for weight
    (1e-5 of its scale), and the grad through ``sn_weight`` (its power
    iteration's vectors outside the gradient) likewise."""
    jmpd, jmsd, mpd, msd, _, _ = hifigan_discs
    for jc, tc in ((jmpd[0]["convs"][1], mpd.discriminators[0].convs[1]),
                   (jmsd[1]["convs"][2], msd.discriminators[1].convs[2])):
        ref = np.asarray(jD.wn_weight(jc)["w"]).transpose(2, 1, 0)
        _close(tc.weight().detach().numpy(), ref, 1e-6)
    for j in (0, 3, 6):
        jc, tc = jmsd[0]["convs"][j], msd.discriminators[0].convs[j]
        ref = np.asarray(jD.sn_weight(jc)["w"]).transpose(2, 1, 0)
        _close(tc.weight().detach().numpy(), ref, 1e-5)
    jc, tc = jmsd[0]["convs"][2], msd.discriminators[0].convs[2]
    r = np.random.RandomState(5).randn(*tc.weight_bar.shape).astype(
        np.float32)
    jg = jax.grad(lambda w: (jD.sn_weight({"w_bar": w, "b": jc["b"]})["w"]
                             * jnp.asarray(r.transpose(2, 1, 0))).sum())(
        jnp.asarray(jc["w_bar"]))
    tg, = torch.autograd.grad((tc.weight() * _t(r)).sum(), [tc.weight_bar])
    _close(tg.numpy(), np.asarray(jg).transpose(2, 1, 0), 1e-5)


def test_gan_losses_match_jax(hifigan_discs):
    """discriminator_loss, generator_loss and feature_loss (with its factor
    2) on the MPD's outputs (1e-5)."""
    jmpd, jmsd, mpd, msd, y, y_hat = hifigan_discs
    rs, gs, fr, fg = _J_MPD(jmpd, jnp.asarray(y), jnp.asarray(y_hat))
    with torch.no_grad():
        trs, tgs, tfr, tfg = mpd(_t(y), _t(y_hat))
    for got, ref in ((tD.discriminator_loss(trs, tgs),
                      jD.discriminator_loss(rs, gs)),
                     (tD.generator_loss(tgs), jD.generator_loss(gs)),
                     (tD.feature_loss(tfr, tfg), jD.feature_loss(fr, fg))):
        np.testing.assert_allclose(float(got), float(ref), rtol=1e-5)


# ------------------------------------------------------------- STFT loss --

def test_multi_resolution_stft_loss_matches_jax():
    """Both terms at the three default resolutions on 4,000 samples
    (1e-5), and the grad of their sum (reflect-centred STFT, power floored
    at 1e-7: finite where the prediction is exactly zero).  The grad of the
    log-magnitude term divides by each bin's magnitude: against float64
    the port's f32 grad reads up to 7e-5 of its scale and JAX's 4.4e-4, so
    it is held within 1e-3 of JAX's and 2e-4 of the port's own in float64."""
    rng = np.random.RandomState(0)
    y = (rng.randn(4000) * 0.3).astype(np.float32)
    y_hat = (rng.randn(4000) * 0.3).astype(np.float32)
    y_hat[1000:1600] = 0.0
    ref = jstft.multi_resolution_stft_loss(jnp.asarray(y_hat), jnp.asarray(y))
    x = _t(y_hat).requires_grad_(True)
    got = tstft.multi_resolution_stft_loss(x, _t(y))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g.detach()), float(r), rtol=1e-5)
    jg = jax.jit(jax.grad(lambda a: sum(jstft.multi_resolution_stft_loss(
        a, jnp.asarray(y)))))(jnp.asarray(y_hat))
    tg, = torch.autograd.grad(sum(got), [x])
    assert np.isfinite(tg.numpy()).all()
    _close(tg.numpy(), np.asarray(jg), 1e-3)
    x64 = torch.from_numpy(y_hat.astype(np.float64)).requires_grad_(True)
    t64, = torch.autograd.grad(sum(tstft.multi_resolution_stft_loss(
        x64, torch.from_numpy(y.astype(np.float64)))), [x64])
    _close(tg.numpy(), t64.numpy(), 2e-4)


# ----------------------------------------------------- PQMF and the source --

def test_pqmf_matches_jax():
    """Filters equal to JAX's (and through the converter), analysis and
    synthesis within 1e-5, and the round trip within 5% of the input at
    its 2-sample delay (tests/test_vocoder_training.py's criterion)."""
    jq, tq = jpqmf.PQMF(), tpqmf.PQMF()
    buffers = convert.pqmf_jax_to_torch(jq)
    for k, v in tq.state_dict().items():
        np.testing.assert_allclose(v.numpy(), buffers[k].numpy(), atol=1e-7)
    rng = np.random.RandomState(0)
    t = np.arange(4096) / 16000.0
    x = (np.sin(2 * np.pi * 440 * t)[None] * 0.5
         + 0.01 * rng.randn(2, 4096)).astype(np.float32)
    ref_sub = np.asarray(jq.analysis(jnp.asarray(x)))
    got_sub = tq.analysis(_t(x)).numpy()
    _close(got_sub, ref_sub, 1e-5)
    ref = np.asarray(jq.synthesis(jnp.asarray(ref_sub)))
    got = tq.synthesis(_t(ref_sub)).numpy()
    _close(got, ref, 1e-5)
    rec = tq.synthesis(tq.analysis(_t(x))).numpy()
    err = (np.abs(x - np.roll(rec, -2, axis=1))[:, 100:-100].mean()
           / np.abs(x[:, 100:-100]).mean())
    assert err < 0.05, err


def _jax_cyc_draws(rng, shape, n_k):
    """The unit-normal draws inside JAX's source_module_cyc_noise(rng)."""
    k1, k2 = jax.random.split(rng)
    ka, kb = jax.random.split(k1)
    return tuple(_t(np.asarray(jax.random.normal(k, s)))
                 for k, s in ((ka, shape), (kb, (n_k,)), (k2, shape)))


def test_source_matches_jax_on_the_same_draws():
    """pulse_gen, cyclic_noise_gen and source_module_cyc_noise on JAX's
    draws (1e-5): a voiced half at 125 Hz and 250 Hz rows (phase steps of
    1/64 and 1/32, exact in f32, so both cumsums wrap at the same samples),
    an unvoiced half; the kernel of length int(4.6 sr / 40) + 1."""
    sr = 8000
    f0 = np.concatenate([np.stack([np.full(2000, 125.0),
                                   np.full(2000, 250.0)]),
                         np.zeros((2, 2000))], 1).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    noise = _t(np.asarray(jax.random.normal(rng, f0.shape)))
    ref = jsource.pulse_gen(rng, jnp.asarray(f0), sr)
    got = tsource.pulse_gen(_t(f0), sr, noise)
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r), 1e-5)
    n_k = tsource.kernel_length(sr)
    draws = _jax_cyc_draws(rng, f0.shape, n_k)
    ref = jsource.source_module_cyc_noise(rng, jnp.asarray(f0), sr)
    got = tsource.source_module_cyc_noise(_t(f0), sr, draws)
    for g, r in zip(got, ref):
        _close(g.numpy(), np.asarray(r), 1e-5)
    assert np.abs(got[0].numpy()[:, :2000]).max() > 1e-3
    g = torch.Generator().manual_seed(0)
    shapes = [d.shape for d in tsource.draw_cyc_noise(2, 4000, sr,
                                                      generator=g)]
    assert shapes == [d.shape for d in draws]


# ---------------------------------------------------------------- serving --


def test_istft_head_batched_sharded_matches_jax(fused_sides, tmp_path):
    """``FusedSvc.batched_sharded`` with the iSTFT head over two CPU
    devices, 3 chunks padded to 4 (tests/test_fused_sharded.py:86's case):
    against JAX's on a 2-device mesh with each chunk's start noise from
    JAX's ``split(rng, 4)`` (waveform and mel within 1e-5 relative L2:
    4e-7 and 7e-8 read on the CPU), and against the port's own ``batched``
    on the same noise (1e-5).  The head is served on the NSF mel's
    geometry, draws nothing, and a weight changed in place rebuilds the
    program."""
    from types import SimpleNamespace

    from _torch_fixtures import voiced_wav
    from diffsvc_tpu.infer.fused import FusedSvc as JFusedSvc
    from diffsvc_tpu_torch.infer.fused import FusedSvc
    from test_torch_fused import ACC, _jax_draws

    tsvc, thub, jsvc, jhp, jcfg = fused_sides
    over = dict(vocoder="istftvocoder", use_nsf=True, istft_dim=64,
                istft_layers=2)
    hp_j = type(jsvc.hp)(jsvc.hp, **over)
    icfg = jih.IstftVocoderConfig.from_hparams(hp_j)
    ip = jih.init(jax.random.PRNGKey(9), icfg)
    npz = str(tmp_path / "istft.npz")
    jih.save_params(npz, ip)
    tvoc = tih.IstftVocoder(dict(tsvc.hp, **over, vocoder_ckpt=npz))
    jf = JFusedSvc(hp_j, jsvc.params, SimpleNamespace(params=ip, cfg=icfg),
                   hubert_params=jhp, hubert_cfg=jcfg, speedup=ACC)
    tf = FusedSvc(type(tsvc.hp)(tsvc.hp, **over), tsvc.model, tvoc, thub,
                  speedup=ACC)
    wavs = [voiced_wav(secs=0.5 + 0.15 * i, f0=180.0 + 40 * i, seed=i)
            for i in range(3)]
    g = tf.geometry(tf._padded_length(max(map(len, wavs))))
    hop = int(tsvc.hp["hop_size"])
    n44 = tf._padded_length(max(map(len, wavs)))
    assert g["t_mel"] == 1 + (n44 + 2 * ((256 - hop) // 2) - 256) // hop
    assert g["n_voc"] == g["t_mel"] * hop
    rng = jax.random.PRNGKey(5)
    ref = jf.batched_sharded(wavs, _mesh(), rng=rng)
    noise = np.concatenate([_jax_draws(k, g["pad_t"], g["n_voc"])[0]
                            for k in jax.random.split(rng, 4)[:3]])
    got = tf.batched_sharded(wavs, ["cpu", "cpu"], init_noise=noise)
    own = tf.batched(wavs, init_noise=noise)
    assert len(got) == len(ref) == len(own) == 3
    for (gw, gf, gm), (rw, _, rm), (ow, of, om) in zip(got, ref, own):
        assert _rel_l2(gw, np.asarray(rw)[: len(gw)]) <= 1e-5
        assert _rel_l2(gm, np.asarray(rm)[: len(gm)]) <= 1e-5
        np.testing.assert_allclose(gw, ow, atol=1e-5)
        np.testing.assert_allclose(gm, om, atol=1e-5)
    with torch.no_grad():
        tvoc.gen.final_ln.weight.mul_(0.5)
    moved = tf.batched(wavs, init_noise=noise)
    assert np.abs(moved[0][0] - own[0][0]).max() > 1e-4


def test_refusals_pwg_fused_and_istft_infer_batched(fused_sides, tmp_path):
    """PWG on a fused route and the iSTFT head on ``Svc.infer_batched``
    raise their clear errors (the JAX package's fused program cannot run
    PWG, and its infer_batched crashes on the iSTFT head)."""
    import copy

    from diffsvc_tpu_torch.infer.fused import FusedSvc

    tsvc, thub, _, _, _ = fused_sides
    d = str(tmp_path / "pwg")
    _write_pwg_dir(d)
    pwg_voc = thifigan.PWG(dict(vocoder="PWG", vocoder_ckpt=d))
    with pytest.raises(ValueError, match="fused program cannot run the PWG"):
        FusedSvc(tsvc.hp, tsvc.model, pwg_voc, thub)
    svc = copy.copy(tsvc)
    svc.vocoder, svc._fused = pwg_voc, None
    svc.hubert = copy.copy(tsvc.hubert)
    svc.hubert.model = thub
    with pytest.raises(ValueError, match="fused program cannot run the PWG"):
        svc.infer_fused(np.zeros(4000, np.float32))
    svc.hp = dict(tsvc.hp, vocoder="IstftVocoder")
    with pytest.raises(ValueError, match="infer_batched does not take"):
        svc.infer_batched(["unused.wav"], key=0, acc=10)


def test_pwg_svc_routes_match_jax(tmp_path, monkeypatch):
    """A 24 kHz project with ``vocoder: PWG`` and ``loud_norm``: the
    modular route against the JAX chain (the same start noise, PWG's z
    from seed 0) within 1e-5 relative L2 on the waveform (1.1e-7 read on
    the CPU), and ``infer_batched`` vocoding each chunk through
    ``spec2wav`` equal to the modular route (1e-5)."""
    from _torch_fixtures import fake_units
    from diffsvc_tpu.infer.svc import Svc as JSvc
    from diffsvc_tpu_torch.infer.svc import Svc as TSvc
    from diffsvc_tpu_torch.utils import synth
    from diffsvc_tpu_torch.utils.audio_io import save_wav
    from test_torch_24k import ACC, HP24, VOC24

    root = tmp_path / "proj"
    cfg_fn, ckpt = synth.write_project(
        str(root), dict(HP24, vocoder="network.vocoders.pwg.PWG",
                        loud_norm=True), VOC24)
    d = str(root / "pwg")
    synth.write_pwg(d, dict(layers=6, stacks=2, residual_channels=8,
                            gate_channels=16, skip_channels=8,
                            aux_channels=16, aux_context_window=2,
                            upsample_params={"upsample_scales": [4, 4, 4,
                                                                 2]}),
                    hop_size=128, seed=1)
    with open(cfg_fn) as f:
        cfg = yaml.safe_load(f)
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(dict(cfg, vocoder_ckpt=d), f)
    wav_fn = str(tmp_path / "in.wav")
    save_wav(synth.voiced_wav(0.8, 24000, 200.0), wav_fn, 24000)
    monkeypatch.chdir(tmp_path)
    tsvc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
    jsvc = JSvc("proj", cfg_fn, False, ckpt)
    assert isinstance(tsvc.vocoder, thifigan.PWG)
    tsvc.hubert.encode = jsvc.hubert.encode = lambda w: fake_units(w, 32)
    batch = jsvc.pre(wav_fn, ACC, use_crepe=False)
    jb = {k: jnp.asarray(batch[k]) for k in
          ("hubert", "mels", "mel2ph", "energy", "f0", "uv")}
    noise = np.random.RandomState(11).randn(
        *batch["mels"].shape).astype(np.float32)
    out = jsvc.model.infer(jsvc.params, jb, jax.random.PRNGKey(0),
                           speedup=ACC, init_noise=jnp.asarray(noise))
    mel = np.asarray(out["mel_out"])[0]
    mask = np.abs(mel).sum(-1) > 0
    ref = jsvc.vocoder.spec2wav(np.clip(mel[mask], jsvc.hp["mel_vmin"],
                                        jsvc.hp["mel_vmax"]))
    _, _, wav = tsvc.infer(wav_fn, key=0, acc=ACC, use_pe=False,
                           use_crepe=False, init_noise=noise)
    assert _rel_l2(wav, ref) <= 1e-5
    (_, _, b_wav), = tsvc.infer_batched([wav_fn], key=0, acc=ACC,
                                        use_pe=False, use_crepe=False,
                                        init_noise=[noise[0]])
    np.testing.assert_allclose(b_wav, wav, atol=1e-5)
