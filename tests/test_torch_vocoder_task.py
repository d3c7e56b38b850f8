"""GAN vocoder training of the port against the JAX package on the CPU:
one ``VocoderTask`` step per family (hifigan with NSF, the iSTFT head,
PWG with its residual discriminator) from the same weights, crops and
draws, comparing the losses, the D and G grads and the updated params;
``crop_batch``; ``train_vocoder`` through ``run_task`` with a checkpoint
and a resume.

Tiny widths (8 kHz, 16 mel, hop 64; HiFi-GAN 32 channels, rates 4, 4, 4;
the iSTFT head 32 x 1; PWG 4 layers of 8 / 16 / 8).  MPD and MSD have no
width option in either package: their module constants are set small for
this file (periods 2 and 3 of three convs each, MSD scales of four convs
up to 32 channels; the JAX package's ``apply_msd`` reads ``_MSD_SPECS``,
and its ``apply_mpd`` takes the periods its parameters have), which keeps
each JAX step's compile short; tests/test_torch_vocoders.py holds them at
full width.  Each JAX step is compiled once per family (module-scoped
fixtures).  The JAX step's grads come out of its optimizer state: a
transform chained before optax's adamw keeps the updates it is given.

Tolerances: losses 1e-5 relative; grads 1e-4 relative L2 per parameter
(f32 sums in other orders through two networks); the updated params
within 1e-3 lr of optax's adamw applied to the port's own grads (an
element whose grad is near 0 can take the other sign in JAX's step, and
Adam's first update is about lr * sign(g), so JAX's updated params are not
the reference for them).  The optimizer itself is held to optax's over 20
steps on fixed grads in float64 (2e-7 relative L2: JAX's rate is a float32),
with torch's default weight decay and betas and an undecayed rate as
planted faults.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_vocoders import _disc_tree
from diffsvc_tpu.config import HParams as JHParams
from diffsvc_tpu.training import vocoder_task as jvt
from diffsvc_tpu.utils import convert_torch as jcvt
from diffsvc_tpu.vocoders import discriminators as jD
from diffsvc_tpu.vocoders import pwg as jpwg
from diffsvc_tpu_torch.config import HParams
from diffsvc_tpu_torch.data.indexed_datasets import IndexedDatasetBuilder
from diffsvc_tpu_torch.run import run_task
from diffsvc_tpu_torch.training import checkpoint as ckpt_lib
from diffsvc_tpu_torch.training import vocoder_task as tvt
from diffsvc_tpu_torch.utils import convert
from diffsvc_tpu_torch.vocoders import discriminators as tD
from diffsvc_tpu_torch.vocoders import istft_head as tih

LR = 2e-4
BASE = dict(audio_sample_rate=8000, audio_num_mel_bins=16, fft_size=256,
            hop_size=64, win_size=256, fmin=30, fmax=4000, vocoder_lr=LR,
            lambda_mel=45.0, seed=0, use_nsf=True, upsample_initial_channel=32,
            upsample_rates=(4, 4, 4), upsample_kernel_sizes=(8, 8, 8),
            resblock="1", resblock_kernel_sizes=(3,),
            resblock_dilation_sizes=((1, 3),))
FAMILIES = {
    "hifigan": dict(vocoder="nsf_hifigan"),
    "istft": dict(vocoder="istftvocoder", istft_dim=32, istft_layers=1),
    "pwg": dict(vocoder="pwg", vocoder_family="pwg",
                pwg_discriminator="residual", pwg_layers=4, pwg_stacks=2,
                pwg_residual_channels=8, pwg_gate_channels=16,
                pwg_skip_channels=8, pwg_disc_layers=4, pwg_disc_stacks=2),
}
SEGMENT = {"hifigan": 8, "istft": 8, "pwg": 16}


def _batch(s, seed=0):
    rng = np.random.RandomState(seed)
    return {"mels": (rng.randn(2, s, 16) * 0.5 - 2.0).astype(np.float32),
            "wav": (rng.randn(2, s * 64) * 0.1).astype(np.float32),
            "f0": np.where(rng.rand(2, s) < 0.2, 0.0, 220.0).astype(
                np.float32)}


def _stash():
    """An optax transform that keeps the updates it is given (the grads,
    when it comes first in a chain) as its state."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda u, s, p=None: (u, u))


def _np(t):
    return t.detach().cpu().numpy()


def _pwg_tree_to_torch(p, prefix=""):
    """JAX PWG generator / residual discriminator tree -> the official
    keys (the inverse of ``pwg.convert`` on unnormed weights)."""
    sd = {}
    names = {"first_conv": "first_conv" if "upsample_conv_in" in p
             else "first_conv.0", "last_conv1": "last_conv_layers.1",
             "last_conv2": "last_conv_layers.3",
             "upsample_conv_in": "upsample_net.conv_in"}
    for k, name in names.items():
        if k in p:
            convert._conv(sd, prefix + name, p[k])
    for j, up in enumerate(p.get("upsample_convs", [])):
        sd[f"{prefix}upsample_net.upsample.up_layers.{2 * j + 1}.weight"] = \
            torch.from_numpy(np.asarray(up["w"])[None, None])
    for j, lp in enumerate(p["layers"]):
        for k, name in (("conv", "conv"), ("aux", "conv1x1_aux"),
                        ("out", "conv1x1_out"), ("skip", "conv1x1_skip")):
            if k in lp:
                convert._conv(sd, f"{prefix}conv_layers.{j}.{name}", lp[k])
    return sd


def _jax_params(task):
    """The port task's weights as JAX's (g_params, d_params)."""
    sd = {k: _np(v) for k, v in task.gen.state_dict().items()}
    if task.family == "istft":
        g = tih.jax_tree(task.gen)
    elif task.family == "pwg":
        g = jpwg.convert(sd, jpwg.PWGConfig(**task.pcfg._asdict()))
    else:
        g = jcvt.convert_hifigan_generator(sd, task.cfg)
    if task.family == "pwg":
        dsd = {k: _np(v) for k, v in task.disc["pwg"].state_dict().items()}
        d = {"pwg": jpwg.convert_residual_discriminator(
            dsd, jpwg.ResidualPWGDiscriminatorConfig(
                **task.disc["pwg"].cfg._asdict()))}
    else:
        d = {"mpd": _disc_tree(task.disc["mpd"]),
             "msd": _disc_tree(task.disc["msd"])}
    return g, d


def _to_torch(tree, task, part):
    """A JAX tree of the generator's or discriminator's shape -> the port's
    state-dict keys."""
    if part == "d":
        if task.family == "pwg":
            return _pwg_tree_to_torch(tree["pwg"], "pwg.")
        return {f"{k}.{n}": v for k in ("mpd", "msd") for n, v in
                convert.hifigan_discriminator_jax_to_torch(tree[k]).items()}
    if task.family == "istft":
        return convert.istft_jax_to_torch(tree)
    if task.family == "pwg":
        return _pwg_tree_to_torch(tree)
    return convert.generator_jax_to_torch(tree)


def _jax_draws(task, batch, rng):
    """JAX's step draws from ``fold_in(rng, 0)``: the NSF source's
    (uniform, normal) pair or PWG's z."""
    key = jax.random.fold_in(rng, 0)
    b, s = batch["mels"].shape[:2]
    if task.family == "pwg":
        return torch.from_numpy(np.array(jax.random.normal(
            key, (b, s * 64), jnp.float32)))
    if task.family == "hifigan":
        k1, k2 = jax.random.split(key)
        return (torch.from_numpy(np.array(jax.random.uniform(
                    k1, (b, 9), dtype=jnp.float32))),
                torch.from_numpy(np.array(jax.random.normal(
                    k2, (b, 9, s * 64), jnp.float32))))
    return None


SMALL_MSD = [(15, 1, 1, 1, 16), (41, 2, 4, 16, 16), (41, 4, 16, 16, 32),
             (5, 1, 1, 32, 32)]


@pytest.fixture(scope="module")
def small_discs():
    """MPD and MSD of both packages at small widths for this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tD, "PERIODS", (2, 3))
        mp.setattr(tD, "MPD_CHANNELS", ((1, 8), (8, 16), (16, 16)))
        mp.setattr(tD, "MSD_SPECS", tuple(SMALL_MSD))
        mp.setattr(jD, "_MSD_SPECS", list(SMALL_MSD))
        yield


@pytest.fixture(scope="module", params=list(FAMILIES))
def stepped(request, small_discs):
    fam = request.param
    hp = dict(BASE, **FAMILIES[fam])
    task = tvt.VocoderTask(HParams(hp), device="cpu")
    assert task.family == fam
    jtask = jvt.VocoderTask(JHParams(hp))
    sched = optax.exponential_decay(LR, 1000, 0.999)
    jtask.tx_g, jtask.tx_d = (optax.chain(_stash(), optax.adamw(
        sched, b1=0.8, b2=0.99)) for _ in range(2))
    g, d = _jax_params(task)
    state = {"g_params": g, "d_params": d, "g_opt": jtask.tx_g.init(g),
             "d_opt": jtask.tx_d.init(d), "step": jnp.zeros((), jnp.int32)}
    before = {k: v.clone() for part in (task.gen, task.disc)
              for k, v in part.state_dict().items()}
    batch = _batch(SEGMENT[fam])
    rng = jax.random.PRNGKey(7)
    jstate, jm = jtask.train_step(state, batch, rng)
    m = task.train_step(batch, draws=_jax_draws(task, batch, rng))
    return fam, task, jstate, jm, m, before


def test_step_losses_match_jax(stepped):
    """Every metric of the step (d_loss, g_loss and the generator's terms;
    the STFT loss for PWG) within 1e-5 relative."""
    fam, task, jstate, jm, m, _ = stepped
    assert set(m) == set(jm)
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
    assert task.step == int(jstate["step"]) == 1


@pytest.mark.parametrize("part", ["d", "g"])
def test_step_grads_match_jax(stepped, part):
    """D's grads (against G's output with no gradient) and G's (against
    the updated D): each parameter within 1e-4 relative L2 of JAX's."""
    fam, task, jstate, _, _, _ = stepped
    mod = task.disc if part == "d" else task.gen
    ref = _to_torch(jax.tree_util.tree_map(
        np.asarray, jstate[f"{part}_opt"][0]), task, part)
    named = dict(mod.named_parameters())
    assert set(ref) == set(named)
    for k, p in named.items():
        r = ref[k].numpy().reshape(p.shape)
        g = _np(p.grad)
        rel = np.linalg.norm(g - r) / max(np.linalg.norm(r), 1e-30)
        assert rel <= 1e-4, (k, rel)


def _optax_adamw():
    """The JAX package's vocoder optimizer (vocoder_task.py's
    ``optax.adamw(exponential_decay(lr, 1000, 0.999), b1=0.8, b2=0.99)``)."""
    return optax.adamw(optax.exponential_decay(LR, 1000, 0.999), b1=0.8,
                       b2=0.99)


def test_step_params_match_jax(stepped):
    """Each updated param equals optax's adamw (JAX's optimizer: weight
    decay 1e-4, the decayed rate at count 0) applied to the port's own
    grads from the same init, within 1e-3 lr elementwise; every parameter
    with a grad moved (the residual discriminator's last conv1x1_out feeds
    nothing)."""
    fam, task, jstate, _, _, before = stepped
    tx = _optax_adamw()
    for mod in (task.disc, task.gen):
        named = dict(mod.named_parameters())
        p0 = {k: jnp.asarray(_np(before[k])) for k in named}
        grads = {k: jnp.asarray(_np(p.grad)) for k, p in named.items()}
        upd, _ = tx.update(grads, tx.init(p0), p0)
        ref = optax.apply_updates(p0, upd)
        for k, p in named.items():
            assert np.abs(_np(p) - np.asarray(ref[k])).max() <= 1e-3 * LR, k
            if p.grad.abs().max() > 0:
                assert not torch.equal(p.detach(), before[k]), k


@pytest.mark.parametrize("fault", [None, "weight decay 1e-2",
                                   "betas (0.9, 0.999)", "constant rate"])
def test_adamw_matches_optax(fault, monkeypatch):
    """The task's generator optimizer through ``VocoderTask._update`` (its
    AdamW, and the rate it sets from the update count), 20 steps on fixed
    random grads in float64, against optax's adamw on the same grads and
    params: the total update within 2e-7 relative L2.  The reference is not
    exact: optax's exponential_decay returns a float32 rate even under
    x64, so JAX's rate is the port's rounded to float32 (3.5e-8 read).
    Each planted fault (torch's default weight decay or betas, the rate
    left undecayed: 9e-6 after 20 updates) reads above that limit."""
    task = tvt.VocoderTask(HParams(dict(BASE, **FAMILIES["hifigan"])),
                           device="cpu")
    task.gen.double()
    params = list(task.gen.parameters())
    p0 = [p.detach().clone() for p in params]
    rng = np.random.RandomState(0)
    grads = [[rng.randn(*p.shape) * 1e-3 for p in params] for _ in range(20)]
    group = task.opt_g.param_groups[0]
    if fault == "weight decay 1e-2":
        group["weight_decay"] = 1e-2
    elif fault == "betas (0.9, 0.999)":
        group["betas"] = (0.9, 0.999)
    elif fault == "constant rate":
        monkeypatch.setattr(tvt, "DECAY_RATE", 1.0)
    for gs in grads:
        loss = sum((p * torch.from_numpy(g)).sum()
                   for p, g in zip(params, gs))
        task._update(task.opt_g, task.gen, loss)
    got = np.concatenate([_np(p - q).ravel() for p, q in zip(params, p0)])
    with jax.enable_x64(True):
        tx = _optax_adamw()
        jp = [jnp.asarray(_np(q)) for q in p0]
        state = tx.init(jp)
        for gs in grads:
            upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
            jp = optax.apply_updates(jp, upd)
        ref = np.concatenate([(np.asarray(a) - _np(q)).ravel()
                              for a, q in zip(jp, p0)])
    assert got.dtype == ref.dtype == np.float64
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    if fault is None:
        assert rel <= 2e-7, rel
    else:
        assert rel > 2e-7, rel


def test_crop_batch_equals_jax():
    """The same items and RandomState give the same crops (short items
    zero-padded)."""
    rng = np.random.RandomState(0)
    items = [{"mel": rng.randn(n, 16), "wav": rng.randn(n * 64),
              "f0": rng.rand(n) * 200} for n in (100, 40, 10)]
    hp = {"hop_size": 64}
    got = tvt.crop_batch(items, hp, np.random.RandomState(3), 32)
    ref = jvt.crop_batch(items, JHParams(hp), np.random.RandomState(3), 32)
    assert set(got) == set(ref)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k])
    assert tvt._factor_scales(128) == jvt._factor_scales(128) == (4, 4, 4, 2)
    assert tvt._factor_scales(512) == jvt._factor_scales(512)


def _write_items(data_dir, n=4, seed=0):
    """A binarized train split that kept its waveforms (mel, wav, f0)."""
    os.makedirs(data_dir, exist_ok=True)
    rng = np.random.RandomState(seed)
    split = IndexedDatasetBuilder(f"{data_dir}/train")
    lengths = []
    for i in range(n):
        t = 20 + 3 * i
        split.add_item({"item_name": f"v{i}",
                          "mel": (rng.randn(t, 16) * 0.5 - 3).astype(
                              np.float32),
                          "wav": (rng.randn(t * 64) * 0.1).astype(np.float32),
                          "f0": np.full(t, 180.0 + 20 * i, np.float32)})
        lengths.append(t)
    split.finalize()
    np.save(f"{data_dir}/train_lengths.npy", np.array(lengths))


def test_train_vocoder_checkpoints_and_resumes(tmp_path):
    """``run_task`` with a vocoder ``task_cls`` trains (PWG family, tiny):
    three steps with a checkpoint at 2 and at 3; a run resumed from the
    step-2 checkpoint alone ends at the same step-3 weights and optimizer
    state bit for bit (its crops from the saved RandomState, its draws a
    function of the step); items without waveforms are refused."""
    data = str(tmp_path / "bin")
    _write_items(data)
    hp = dict(BASE, **FAMILIES["pwg"], binary_data_dir=data,
              work_dir=str(tmp_path / "work"), max_sentences=2,
              vocoder_segment_frames=16, max_updates=3, log_interval=1,
              val_check_interval=2, num_ckpt_keep=5,
              task_cls="training.task.vocoder.PwgTask")
    task = run_task(HParams(hp), device="cpu")
    assert isinstance(task, tvt.VocoderTask) and task.step == 3
    assert [h["step"] for h in task.history] == [1, 2, 3]
    assert all(np.isfinite(v) for h in task.history for v in h.values())
    work = tmp_path / "work"
    assert sorted(os.listdir(work)) == ["model_ckpt_steps_2.ckpt",
                                        "model_ckpt_steps_3.ckpt"]
    resumed = tmp_path / "resumed"
    resumed.mkdir()
    os.link(work / "model_ckpt_steps_2.ckpt",
            resumed / "model_ckpt_steps_2.ckpt")
    task2 = run_task(HParams(dict(hp, work_dir=str(resumed))), device="cpu")
    assert task2.step == 3 and [h["step"] for h in task2.history] == [3]
    a = ckpt_lib.restore_checkpoint(str(work))[0]
    b = ckpt_lib.restore_checkpoint(str(resumed))[0]
    for k, v in a["state_dict"].items():
        assert torch.equal(b["state_dict"][k], v), k
    for sa, sb in zip(a["optimizer_states"], b["optimizer_states"]):
        for i, st in sa["state"].items():
            for k, v in st.items():
                assert torch.equal(sb["state"][i][k], v), (i, k)
    assert a["global_step"] == 3
    nowav = tmp_path / "nowav"
    nowav.mkdir()
    split = IndexedDatasetBuilder(str(nowav / "train"))
    split.add_item({"mel": np.zeros((20, 16), np.float32),
                      "f0": np.zeros(20, np.float32)})
    split.finalize()
    np.save(str(nowav / "train_lengths.npy"), np.array([20]))
    with pytest.raises(ValueError, match="with_wav"):
        run_task(HParams(dict(hp, binary_data_dir=str(nowav),
                              work_dir=str(tmp_path / "w3"))), device="cpu")
