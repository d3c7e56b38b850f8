"""FS2-full (``no_fs2: false``) and the FFT denoiser
(``diff_decoder_type: fft``) of the port against the JAX package on the
CPU: the FFT blocks, the conditioner with its encoder and decoder, the
denoiser, one training step each (at dropout 0, JAX's numbers), the
sampling of the FFT denoiser (JAX's scans, never the ladder), the state-dict
names the reference converter reads, and the three points where a direct
PyTorch translation would differ from JAX (tanh GELU, a finite mask,
dropout's scaling).  Dims are ``tests/test_fs2_full_training.py``'s."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from _torch_fixtures import HOP, TINY_HP, fake_units, voiced_wav
from diffsvc_tpu.config import HParams
from diffsvc_tpu.infer.svc import Svc as JSvc
from diffsvc_tpu.models import candidate_decoder as jcd
from diffsvc_tpu.models import fs2 as jfs2
from diffsvc_tpu.models import tts_modules as jtts
from diffsvc_tpu.models.diffusion import GaussianDiffusion as JDiffusion
from diffsvc_tpu.training.task import SVCTask as JTask
from diffsvc_tpu.utils.audio_io import save_wav
from diffsvc_tpu.utils.convert_torch import convert_fs2, strip_prefix
from diffsvc_tpu_torch.infer.svc import Svc as TSvc
from diffsvc_tpu_torch.models import tts_modules
from diffsvc_tpu_torch.models.diffusion import GaussianDiffusion
from diffsvc_tpu_torch.ops.hopper import plms_ladder
from diffsvc_tpu_torch.training.task import SVCTask
from diffsvc_tpu_torch.utils import synth
from diffsvc_tpu_torch.utils.convert import diffusion_jax_to_torch


def _hp(dec="wavenet", **kw):
    hp = HParams(
        audio_num_mel_bins=16, hidden_size=32, residual_layers=4,
        residual_channels=16, dilation_cycle_length=4, timesteps=20,
        K_step=20, diff_loss_type="l2", schedule_type="linear", max_beta=0.02,
        keep_bins=16, spec_min=[-6.0], spec_max=[1.5],
        no_fs2=dec == "fft", diff_decoder_type=dec, enc_layers=2,
        dec_layers=2, enc_ffn_kernel_size=9, dec_ffn_kernel_size=9,
        num_heads=2, dropout=0.0, use_pitch_embed=True,
        use_energy_embed=False, use_uv=False, pitch_norm="log", f0_bin=256,
        f0_min=50.0, f0_max=1100.0, lr=1e-3, scheduler="step_lr",
        decay_steps=100, optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98,
        weight_decay=0, clip_grad_norm=1, accumulate_grad_batches=1, seed=0,
        pndm_speedup=5, diffnet_train_stream_dtype="f32")
    hp.update(kw)
    return hp


def _pair(hp, seed=0):
    """The JAX model and params, and the port's model holding them."""
    jm = JDiffusion(hp)
    params = jm.init_params(jax.random.PRNGKey(seed))
    tm = GaussianDiffusion(hp)
    tm.load_state_dict(diffusion_jax_to_torch(jax.tree.map(np.asarray,
                                                           params)))
    return jm, params, tm


def _batch(seed=0, b=2, tm=32, tp=16):
    """tests/test_fs2_full_training.py's batch with the second member
    padded: its last units all zero, its last frames mel2ph 0."""
    rng = np.random.RandomState(seed)
    mel2ph = np.clip((np.arange(tm)[None, :] * tp // tm) + 1, 1, tp
                     ).astype(np.int32) * np.ones((b, 1), np.int32)
    hubert = rng.randn(b, tp, 32).astype(np.float32) * 0.1
    hubert[1, 10:] = 0.0
    mel2ph[1, 20:] = 0
    return {"hubert": hubert, "mel2ph": mel2ph,
            "f0": np.full((b, tm), 7.78, np.float32),
            "uv": np.zeros((b, tm), np.float32),
            "energy": np.zeros((b, tm), np.float32),
            "mels": rng.randn(b, tm, 16).astype(np.float32)}


def _t(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["mel2ph"] = out["mel2ph"].long()
    return out


def test_fs2_full_matches_jax():
    """The encoder's conditioner and the decoder's mel_out
    (``skip_decoder=False``) within 1e-5, the padded member included (its
    padded frames exactly zero on both sides)."""
    hp = _hp()
    jm, params, tm = _pair(hp)
    batch = _batch()
    ref = jfs2.apply(params["fs2"], jm.fs2_cfg, *(jnp.asarray(batch[k])
                     for k in ("hubert", "mel2ph", "f0")),
                     skip_decoder=False)
    b = _t(batch)
    got = tm.fs2(b["hubert"], b["mel2ph"], b["f0"], skip_decoder=False)
    for k in ("decoder_inp", "mel_out"):
        want = np.asarray(ref[k])
        g = got[k].detach().numpy()
        assert np.abs(want).max() > 0.1
        np.testing.assert_allclose(g, want, atol=1e-5, err_msg=k)
        assert (g[1, 20:] == 0).all() and (want[1, 20:] == 0).all()


def test_fft_decoder_matches_jax():
    """The FFT denoiser within 1e-5 on noisy mels, steps and a conditioner
    with a padded member."""
    hp = _hp("fft")
    jm, params, tm = _pair(hp, seed=1)
    rng = np.random.RandomState(2)
    spec = rng.randn(2, 32, 16).astype(np.float32)
    cond = rng.randn(2, 32, 32).astype(np.float32)
    cond[1, 20:] = 0.0
    steps = np.array([3, 17], np.int32)
    want = np.asarray(jcd.apply(params["denoise_fn"], jm.net_cfg,
                                jnp.asarray(spec), jnp.asarray(steps),
                                jnp.asarray(cond)))
    got = tm.denoise_fn(torch.from_numpy(spec), torch.from_numpy(steps).long(),
                        torch.from_numpy(cond)).detach().numpy()
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5)


def _jax_draws(jt, batch, step=0, seed=0):
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (batch["mels"].shape[0],), 0,
                           jt.model.cfg.K_step)
    noise = jax.random.normal(n_rng, batch["mels"].shape, jnp.float32)
    return rng, torch.from_numpy(np.array(t)), \
        torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("dec", ["wavenet", "fft"], ids=["fs2_full", "fft"])
def test_train_step_matches_jax(dec):
    """One step at dropout 0 (JAX's numbers) from the same params, batch, t
    and noise: the loss within 1e-5, every gradient within 1e-3 of its
    largest entry and the update as tests/test_torch_training.py holds it
    (within 2 lr, and 1e-6 where the gradient's sign is settled).  The
    encoder (FS2-full) and the denoiser (FFT) get nonzero gradients."""
    hp = _hp(dec)
    jt = JTask(hp)
    state = jt.init_state()
    if dec == "wavenet":    # a zero DiffNet head zeroes every gradient
        op = state["params"]["denoise_fn"]["output_projection"]
        op["w"] = jnp.asarray(np.random.RandomState(3).randn(
            *op["w"].shape).astype(np.float32) * 0.2)
        state["opt_state"] = jt.tx.init(state["params"])
    tt = SVCTask(hp, device="cpu")
    tt.model.load_state_dict(diffusion_jax_to_torch(
        jax.tree.map(np.asarray, state["params"])))
    p0 = {k: v.clone() for k, v in tt.model.state_dict().items()}
    batch = _batch()
    rng, t, noise = _jax_draws(jt, batch)
    jb = jt.prepare_batch(batch)
    gj = jax.grad(lambda p: jt.model.training_loss(p, jb, rng)[0])(
        state["params"])
    new_state, mj = jt.train_step(state, batch, jax.random.PRNGKey(0))
    loss, _ = tt.model.training_loss(tt.prepare_batch(batch), t=t,
                                     noise=noise)
    gt = torch.autograd.grad(loss, tt.params, allow_unused=True)
    mt = tt.train_step(batch, t=t, noise=noise)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    want_g = diffusion_jax_to_torch(jax.tree.map(np.asarray, gj))
    want_p = diffusion_jax_to_torch(jax.tree.map(np.asarray,
                                                 new_state["params"]))
    got_p = tt.model.state_dict()
    part = "fs2.encoder" if dec == "wavenet" else "denoise_fn.layers"
    reached = 0
    for name, g in zip(tt.names, gt):
        ref = want_g[name].numpy()
        g = np.zeros_like(ref) if g is None else g.numpy()
        scale = np.abs(ref).max()
        assert np.abs(g - ref).max() <= 1e-3 * scale + 1e-12, name
        upd = (got_p[name] - p0[name]).numpy()
        upd_ref = (want_p[name] - p0[name]).numpy()
        assert np.abs(upd - upd_ref).max() <= 2 * hp["lr"] + 1e-6, name
        settled = np.abs(ref) > 1e-3 * scale
        np.testing.assert_allclose(upd[settled], upd_ref[settled], atol=1e-6,
                                   err_msg=name)
        reached += name.startswith(part) and scale > 0
    assert reached > 4


@pytest.mark.parametrize("dec", ["wavenet", "fft"], ids=["fs2_full", "fft"])
def test_three_steps_with_dropout(dec):
    """tests/test_fs2_full_training.py on the port: three steps at dropout
    0.1, finite losses, and the encoder's (or the FFT denoiser's) attention
    weights move."""
    hp = _hp(dec, dropout=0.1)
    tt = SVCTask(hp, device="cpu")
    name = ("fs2.encoder" if dec == "wavenet" else "denoise_fn") \
        + ".layers.0.op.self_attn.in_proj_weight"
    p0 = tt.model.state_dict()[name].clone()
    for _ in range(3):
        m = tt.train_step(_batch())
    assert np.isfinite(float(m["loss"]))
    assert not torch.allclose(p0, tt.model.state_dict()[name])


def test_dropout_draws_only_when_training():
    """With dropout > 0 the training loss of an FS2-full model depends on
    the generator (the conditioner's dropout draws come after t and the
    noise), validation's (``train=False``) does not."""
    hp = _hp(dropout=0.1)
    tm = GaussianDiffusion(hp)
    synth.randomize(tm, 0)
    b = _t(_batch())
    t = torch.tensor([3, 11])
    noise = torch.randn(2, 32, 16, generator=torch.Generator().manual_seed(0))

    def loss(seed, train):
        g = torch.Generator().manual_seed(seed)
        return float(tm.training_loss(b, t=t, noise=noise, generator=g,
                                      train=train)[0].detach())

    assert loss(0, True) != loss(1, True)
    assert loss(0, False) == loss(1, False)


def test_dropout_rate_and_scaling():
    """Inverted dropout: about ``rate`` of the entries zeroed, the rest
    divided by 1 - rate; the identity without a generator or at rate 0."""
    x = torch.full((200, 500), 2.0)
    g = torch.Generator().manual_seed(0)
    y = tts_modules.dropout(x, 0.1, g)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.9) < 0.005
    np.testing.assert_allclose(y[kept].numpy(), 2.0 / 0.9, rtol=1e-6)
    assert tts_modules.dropout(x, 0.1, None) is x
    assert tts_modules.dropout(x, 0.0, g) is x


def test_ffn_gelu_is_the_tanh_approximation():
    """The FFN against JAX's ``tts_modules.ffn`` within 1e-6; the same FFN
    with the erf GELU (PyTorch's default) is off by ten times that."""
    torch.manual_seed(0)
    ffn = tts_modules.TransformerFFNLayer(32, 9)
    x = torch.randn(2, 20, 32) * 2
    p = {"conv": {"w": ffn.ffn_1.weight.detach().numpy().transpose(2, 1, 0),
                  "b": ffn.ffn_1.bias.detach().numpy()},
         "out": {"w": ffn.ffn_2.weight.detach().numpy().T,
                 "b": ffn.ffn_2.bias.detach().numpy()}}
    want = np.asarray(jtts.ffn(p, jnp.asarray(x.numpy()), 9))
    got = ffn(x).detach().numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    y = F.conv1d(x.transpose(1, 2), ffn.ffn_1.weight, ffn.ffn_1.bias,
                 padding=4).transpose(1, 2)[:, :20] * 9 ** -0.5
    erf = ffn.ffn_2(F.gelu(y)).detach().numpy()
    assert np.abs(erf - want).max() > 1e-5


def test_all_padding_member_stays_finite(monkeypatch):
    """A batch member whose every frame is padding: the FFT blocks give
    zeros there (JAX's -1e9 mask), and the rest equals JAX's; with a -inf
    mask (``scaled_dot_product_attention``'s boolean mask) the same input
    gives NaN."""
    torch.manual_seed(1)
    blocks = tts_modules.FFTBlocks(32, 2, 9, 2)
    x = torch.randn(2, 12, 32)
    mask = torch.zeros(2, 12, dtype=torch.bool)
    mask[1] = True
    mask[0, 9:] = True
    got = blocks(x, mask).detach().numpy()
    assert np.isfinite(got).all() and (got[1] == 0).all()
    from diffsvc_tpu.utils.convert_torch import convert_fft_blocks

    jp = convert_fft_blocks({k: v.numpy() for k, v in
                             blocks.state_dict().items()}, None)
    want = np.asarray(jtts.apply_fft_blocks(
        jp, jnp.asarray(x.numpy()), jnp.asarray(mask.numpy()), 2, 9))
    np.testing.assert_allclose(got, want, atol=1e-5)
    monkeypatch.setattr(tts_modules, "MASKED", float("-inf"))
    assert not np.isfinite(blocks(x, mask).detach().numpy()).all()


@pytest.mark.parametrize("dec", ["wavenet", "fft"], ids=["fs2_full", "fft"])
def test_state_dict_is_the_reference_layout(dec):
    """JAX params -> the port's state dict loads with ``strict=True``; the
    JAX package's reference converter (``convert_torch.convert_fs2``) reads
    the port's FS2-full state dict back to the same params."""
    hp = _hp(dec)
    jm, params, tm = _pair(hp)
    sd = {k: v.numpy() for k, v in tm.state_dict().items()}
    if dec == "wavenet":
        back = convert_fs2(strip_prefix(sd, "fs2."), jm.fs2_cfg)
        for part in ("encoder", "decoder"):
            for a, b in zip(jax.tree.leaves(back[part]),
                            jax.tree.leaves(params["fs2"][part])):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    else:
        assert "denoise_fn.pos_embed_alpha" in sd
        assert "denoise_fn.layers.1.op.ffn.ffn_1.weight" in sd


@pytest.mark.parametrize("sampler", ["plms", "dpmpp"])
def test_fft_denoiser_samples_as_jax(monkeypatch, sampler):
    """``GaussianDiffusion.infer`` with the FFT denoiser against JAX's
    (its scans: JAX never routes this decoder through the ladder) on the
    same start noise, mel within 1e-4; the port's ladder (K2) is not
    called."""
    hp = _hp("fft", sampler=sampler)
    jm, params, tm = _pair(hp, seed=3)

    def no_ladder(*a, **k):
        raise AssertionError("the FFT denoiser reached K2")

    monkeypatch.setattr(plms_ladder, "plms_ladder", no_ladder)
    batch = _batch(1)
    noise = np.random.RandomState(4).randn(2, 32, 16).astype(np.float32)
    want = jm.infer(params, {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(0), speedup=5,
                    init_noise=jnp.asarray(noise))
    got = tm.infer(_t(batch), speedup=5, init_noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got["mel_out"].numpy(),
                               np.asarray(want["mel_out"]), atol=1e-4)


# ---------------------------------------------------------------------------
# the conversion routes reach the encoder
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fs2_project(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fs2_full")
    config = dict(TINY_HP, no_fs2=False, enc_layers=2, dec_layers=2,
                  num_heads=2, enc_ffn_kernel_size=9, dec_ffn_kernel_size=9,
                  vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN")
    from _torch_fixtures import TINY_VOC

    cfg_fn, ckpt = synth.write_project(str(root / "proj"), config, TINY_VOC)
    wav_fn = str(root / "in.wav")
    save_wav(voiced_wav(secs=1.2, f0=200.0), wav_fn, TINY_HP[
        "audio_sample_rate"])
    return root, cfg_fn, ckpt, wav_fn


def test_svc_fs2_full_matches_jax_and_every_route_runs_the_encoder(
        fs2_project, monkeypatch):
    """An FS2-full checkpoint: the port's ``Svc.infer`` against the JAX
    chain's mel on the same units and start noise (2e-4, the slice test's
    sampler limit), and ``Svc.infer``, the fused program and
    ``infer_batched`` each run the encoder."""
    root, cfg_fn, ckpt, wav_fn = fs2_project
    monkeypatch.chdir(root)
    tsvc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
    jsvc = JSvc("proj", cfg_fn, False, ckpt)
    tsvc.hubert.encode = fake_units
    jsvc.hubert.encode = fake_units
    assert "encoder" in jsvc.params["fs2"]
    calls = []
    tsvc.model.fs2.encoder.register_forward_hook(
        lambda *a: calls.append(1))
    batch = jsvc.pre(wav_fn, 10, use_crepe=False)
    jb = {k: jnp.asarray(batch[k]) for k in
          ("hubert", "mels", "mel2ph", "energy", "f0", "uv")}
    noise = np.random.RandomState(11).randn(
        *batch["mels"].shape).astype(np.float32)
    want = np.asarray(jsvc.model.infer(
        jsvc.params, jb, jax.random.PRNGKey(0), speedup=10,
        init_noise=jnp.asarray(noise))["mel_out"])[0]
    tb = tsvc.pre(wav_fn, 10, use_crepe=False)
    got = tsvc.model.infer(
        {k: torch.as_tensor(tb[k]) for k in
         ("hubert", "mels", "mel2ph", "energy", "f0", "uv")},
        speedup=10, init_noise=torch.from_numpy(noise))["mel_out"][0]
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    assert calls
    calls.clear()
    _, _, wav = tsvc.infer(wav_fn, key=0, acc=10, use_pe=False,
                           use_crepe=False)
    assert np.isfinite(wav).all() and len(calls) == 1
    outs = tsvc.infer_batched([wav_fn, wav_fn], key=0, acc=10, use_pe=False,
                              use_crepe=False)
    assert len(outs) == 2 and len(calls) == 2
    from diffsvc_tpu_torch.infer import hubert_encoder
    from diffsvc_tpu_torch.models.hubert import HubertConfig

    hub_fn = str(root / "hubert_soft.pt")
    synth.write_hubert(hub_fn, HubertConfig(dim=32, num_heads=2, num_layers=1,
                                            ffn_dim=64, proj_dim=32), seed=2)
    tsvc.hubert.model = hubert_encoder.load(
        hub_fn, cfg=HubertConfig(dim=32, num_heads=2, num_layers=1,
                                 ffn_dim=64, proj_dim=32))
    w, f0, mel = tsvc.infer_fused(voiced_wav(secs=0.8, f0=220.0), acc=10)
    assert np.isfinite(w).all() and len(calls) == 3
    assert mel.shape[1] == 16 and len(w) == len(f0) * HOP
