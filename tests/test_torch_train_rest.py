"""The rest of single-card training in the port against the JAX package, on
the CPU: RAdam (optax's update behind clipping and MultiSteps), the FS2
losses and SSIM, the pe task and its checkpoint as ``pe_ckpt``, and
``run.py --infer`` (the test-split runner).

The fixture is ``tests/test_torch_training.py``'s (8 kHz, 16 mel bins,
DiffNet 32 x 4, hidden 256, the same HuBERT-unit stand-in on both sides).
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_fixtures import TINY_HP, TINY_VOC
from diffsvc_tpu.config import HParams
from diffsvc_tpu.data.dataset import FastSpeechDataset as JDataset
from diffsvc_tpu.models import pe as jpe
from diffsvc_tpu.ops import ssim as jssim
from diffsvc_tpu.training import losses as jlosses
from diffsvc_tpu.training import pe_task as jpe_task
from diffsvc_tpu.training import scheduler as jsched
from diffsvc_tpu.training import test_runner as jrunner
from diffsvc_tpu.utils.convert_torch import convert_gaussian_diffusion
from diffsvc_tpu_torch.infer.svc import Svc
from diffsvc_tpu_torch.ops import ssim as tssim
from diffsvc_tpu_torch.run import run_task
from diffsvc_tpu_torch.training import checkpoint as ckpt_lib
from diffsvc_tpu_torch.training import losses as tlosses
from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask
from diffsvc_tpu_torch.training.task import SVCTask, rectification
from diffsvc_tpu_torch.utils import synth
from test_torch_training import (_jax_draws, _tasks, _torch_sd,  # noqa: F401
                                 binarized)

NSF = "diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN"
PE_TASK = "training.pe.PitchExtractionTask"


# --------------------------------------------------------------- RAdam --

def test_radam_rectifies_from_step_six():
    """b2 = 0.98: rho_t is ~4.92 at step 5 and ~5.89 at step 6, so steps
    1-5 take the bias-corrected momentum and 6 on the rectified update
    (optax's >= 5; torch.optim.RAdam's > 5 would agree here)."""
    assert all(rectification(t, 0.98) is None for t in range(1, 6))
    assert 0.1 < rectification(6, 0.98) < rectification(7, 0.98) < 1.0


@pytest.mark.parametrize("accumulate", [1, 2])
def test_radam_matches_optax(binarized, accumulate):
    """8 optimizer steps of SVCTask's RAdam (behind clip_by_global_norm and
    the accumulation window) on fixed random grads, against
    ``optax.chain(clip_by_global_norm, optax.radam(schedule))`` (in
    ``optax.MultiSteps`` for accumulation 2) on the same params: every
    parameter within rtol 1e-5 (atol 1e-7 for the zero-initialized
    ones), so steps 6-8 hold the rectified branch.  ``weight_decay`` is set
    and must not apply (the JAX task's radam has none); the lr steps down
    by half every 3 optimizer steps."""
    _, hps = binarized
    hp = HParams(dict(hps["jax"], optimizer="radam", weight_decay=0.1,
                      accumulate_grad_batches=accumulate, decay_steps=3,
                      lr=2e-3, hidden_size=32))
    tt = SVCTask(hp, device="cpu")
    params = {n: p.detach().numpy().copy() for n, p in
              zip(tt.names, tt.params)}
    tx = optax.chain(optax.clip_by_global_norm(1.0),
                     optax.radam(jsched.build_lr_schedule(hp), b1=0.9,
                                 b2=0.98))
    if accumulate > 1:
        tx = optax.MultiSteps(tx, every_k_schedule=accumulate)
    jp = {n: jnp.asarray(v) for n, v in params.items()}
    state = tx.init(jp)
    update = jax.jit(tx.update)
    rng = np.random.RandomState(accumulate)
    for step in range(8 * accumulate):
        scale = 10.0 ** rng.uniform(-5, -2)    # global norms on both sides of 1
        grads = {n: (rng.randn(*v.shape) * scale).astype(np.float32)
                 for n, v in params.items()}
        upd, state = update({n: jnp.asarray(g) for n, g in grads.items()},
                            state, jp)
        jp = optax.apply_updates(jp, upd)
        lr = tt.apply_grads([torch.from_numpy(grads[n]) for n in tt.names])
        assert lr == pytest.approx(float(jsched.build_lr_schedule(hp)(
            step // accumulate)), rel=1e-6)
    assert tt.opt_steps == 8 and int(tt.optimizer.state_dict()["state"][0][
        "step"]) == 8
    for n, p in zip(tt.names, tt.params):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[n]),
                                   rtol=1e-5, atol=1e-7, err_msg=n)


def test_radam_svctask_step_matches_jax(binarized):
    """One SVCTask step with ``optimizer: radam`` from the same params,
    batch, t and noise as JAX's, in the harness of
    test_torch_training.py::test_train_step_matches_jax and at its
    tolerances (loss 1e-5, grads 1e-3 of each tensor's largest).  RAdam's
    first update is -lr * the clipped grad, so the updates agree to lr times
    the grads' tolerance (plus two float32 ulps of the parameter, the
    rounding of p + update)."""
    _, hps = binarized
    hp = HParams(dict(hps["jax"], optimizer="radam"))
    jt, state, tt = _tasks(hp, head_seed=3)
    ds = JDataset("train", hp, shuffle=False)
    batch = ds.collater([ds[i] for i in range(len(ds))], pad_multiple=32)
    _, t, noise = _jax_draws(jt, batch, 0)
    p0 = _torch_sd(state["params"])
    new_state, mj = jt.train_step(state, batch, jax.random.PRNGKey(0))
    mt = tt.train_step(batch, t=t, noise=noise)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=1e-3)
    want = _torch_sd(new_state["params"])
    lr, moved = hp["lr"], 0
    for name, v in tt.model.state_dict().items():
        if name not in want:
            continue
        upd, ref = v.numpy() - p0[name], want[name] - p0[name]
        ulp = np.finfo(np.float32).eps * np.abs(p0[name]).max()
        assert np.abs(upd - ref).max() <= 1e-3 * np.abs(ref).max() \
            + 2 * ulp, name
        moved += int((np.abs(ref) > 0).sum())
    assert moved > 0


# -------------------------------------------------------------- losses --

def _mels(rng, b=3, t=24, m=16):
    """log-mel-like [B, T, M] with a padded tail and one all-padding row."""
    x = (rng.randn(b, t, m) * 0.7 - 3.0).astype(np.float32)
    x[1, t - 7:] = 0.0
    x[-1] = 0.0
    return x


@pytest.mark.parametrize("case", ["ssim", "ssim_map", "mel_losses",
                                  "mel_losses_mse", "dur", "energy",
                                  "f0_uv_l2", "f0_uv_l1", "f0_no_uv",
                                  "f0_uv_all_padding"])
def test_losses_match_jax(case):
    """SSIM, the mel-loss spec, the duration, energy and pitch losses on
    the same numpy inputs: within 1e-5 (relative, 1e-6 absolute).  The
    SSIM map's elements are compared to 3e-5 absolute: each holds the f32
    cancellation sigma^2 = E[x^2] - mu^2, which leaves either package up to
    1.5e-5 from the f64 map on these inputs (the losses, means over the
    map, hold 1e-5).  The inputs hold an all-padding row;
    ``f0_uv_all_padding`` masks every frame, so the clamped denominators
    give exactly 0."""
    rng = np.random.RandomState(0)
    pred, tgt = _mels(rng), _mels(rng)
    pred[-1] = rng.randn(*pred[-1].shape)      # the padded row predicts noise
    t = torch.from_numpy
    j = jnp.asarray
    if case in ("ssim", "ssim_map"):
        a, b = np.abs(pred) / 8, np.abs(tgt) / 8
        avg = case == "ssim"
        got = tssim.ssim(t(a), t(b), size_average=avg)
        want = jssim.ssim(j(a), j(b), size_average=avg)
        pairs = [(got, want)]
    elif case.startswith("mel_losses"):
        spec = "ssim:0.5|l1:0.5" if case == "mel_losses" else "mse|l2:2"
        got = tlosses.mel_losses(t(pred), t(tgt), spec)
        want = jlosses.mel_losses(j(pred), j(tgt), spec)
        assert got.keys() == want.keys()
        pairs = [(got[k], want[k]) for k in got]
    elif case == "dur":
        mel2ph = np.array([[1, 1, 2, 2, 2, 3, 4, 4, 0, 0],
                           [1, 2, 3, 3, 3, 3, 3, 3, 4, 5]])
        dur_pred = rng.randn(2, 5).astype(np.float32)
        nonpad = np.array([[1, 1, 1, 1, 0], [1, 1, 1, 1, 1]], np.float32)
        pairs = [(tlosses.dur_loss(t(dur_pred), t(mel2ph), 5, t(nonpad)),
                  jlosses.dur_loss(j(dur_pred), j(mel2ph), 5, j(nonpad)))]
    elif case == "energy":
        e_pred, e_gt = rng.randn(2, 3, 10).astype(np.float32)
        nonpad = (rng.rand(3, 10) > 0.3).astype(np.float32)
        nonpad[-1] = 0
        pairs = [(tlosses.energy_loss(t(e_pred), t(e_gt), t(nonpad)),
                  jlosses.energy_loss(j(e_pred), j(e_gt), j(nonpad)))]
    else:
        pitch = rng.randn(3, 20, 2).astype(np.float32)
        f0 = (7.5 + 0.3 * rng.randn(3, 20)).astype(np.float32)
        uv = (rng.rand(3, 20) < 0.3).astype(np.float32)
        nonpad = np.ones((3, 20), np.float32)
        nonpad[1, 14:] = 0
        nonpad[-1] = 0
        if case == "f0_uv_all_padding":
            nonpad[:] = 0
        kw = dict(use_uv=case != "f0_no_uv",
                  pitch_loss="l1" if case == "f0_uv_l1" else "l2",
                  lambda_uv=0.7)
        got = tlosses.f0_uv_losses(t(pitch), t(f0), t(uv), t(nonpad), **kw)
        want = jlosses.f0_uv_losses(j(pitch), j(f0), j(uv), j(nonpad), **kw)
        assert got.keys() == want.keys()
        pairs = [(got[k], want[k]) for k in got]
        if case == "f0_uv_all_padding":
            assert all(float(g) == 0.0 for g, _ in pairs)
    atol = 3e-5 if case == "ssim_map" else 1e-6
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=atol)


# ------------------------------------------------------------- pe task --

PE_HP = dict(TINY_HP, lr=1e-3, scheduler="step_lr", decay_steps=100,
             optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98,
             weight_decay=0.0, clip_grad_norm=1, pitch_type="frame",
             pitch_extractor_conv_layers=2, seed=5)


def _pe_batch(rng, b=3, t=40, m=16):
    mels = (rng.randn(b, t, m) * 0.5 - 2.5).astype(np.float32)
    mels[1, 30:] = 0.0
    f0 = (7.6 + 0.2 * rng.randn(b, t)).astype(np.float32)
    uv = (rng.rand(b, t) < 0.25).astype(np.float32)
    return {"mels": mels, "f0": f0, "uv": uv,
            "sample_mask": np.array([1, 1, 0], np.float32)}


def _pe_tree(model, names=(), grads=()):
    """The port's pe weights, or with ``names``/``grads`` its grads (one per
    parameter), as JAX's params tree through the JAX package's reference
    converter (the BatchNorm running stats are parameters of both
    tasks)."""
    sd = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    sd.update({n: g.detach().numpy() for n, g in zip(names, grads)})
    return jpe.convert(sd)


@pytest.mark.parametrize("accumulate", [1, 2])
def test_pe_task_step_matches_jax(accumulate):
    """PitchExtractionTask's micro-steps against JAX's on the same weights
    (the port's init carried by ``pe.convert``) and batches (a padded tail,
    a masked sample): loss and every grad (the BatchNorm running stats'
    among them) within rtol 1e-4 of each leaf's largest, then the params
    after the window's AdamW update (where |grad| is settled, to 1e-6;
    everywhere within 2 lr); with accumulation 2 nothing moves on the
    first micro-step."""
    hp = HParams(dict(PE_HP, accumulate_grad_batches=accumulate))
    tt = PitchExtractionTask(hp, device="cpu")
    jt = jpe_task.PitchExtractionTask(hp)
    params = _pe_tree(tt.model)
    state = {"params": params, "opt_state": jt.tx.init(params)}
    p0 = {k: v.detach().clone() for k, v in tt.model.state_dict().items()}
    rng = np.random.RandomState(1)
    loss_and_grads = jax.jit(jax.value_and_grad(jt._loss, has_aux=True))
    for step in range(accumulate):
        batch = _pe_batch(rng)
        (lj, _), gj = loss_and_grads(state["params"],
                                     jt.prepare_batch(batch, shard=False))
        lt, _ = tt.loss(batch)
        gt = torch.autograd.grad(lt, tt.params)
        np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-4)
        got = _pe_tree(tt.model, tt.names, gt)
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(got),
                                jax.tree.leaves(gj)):
            b = np.asarray(b)
            assert np.abs(np.asarray(a) - b).max() <= 1e-4 * np.abs(b).max() \
                + 1e-12, jax.tree_util.keystr(path)
        # JAX's train_step after its value_and_grad: the optax chain
        updates, opt_state = jt.tx.update(gj, state["opt_state"],
                                          state["params"])
        state = {"params": optax.apply_updates(state["params"], updates),
                 "opt_state": opt_state}
        mt = tt.train_step(batch)
        np.testing.assert_allclose(float(mt["loss"]), float(lj), rtol=1e-4)
        if step < accumulate - 1:
            for k, v in tt.model.state_dict().items():
                assert torch.equal(v, p0[k]), k
    assert tt.opt_steps == 1 and tt.step == accumulate
    want = jax.tree.leaves(state["params"])
    ref_p0 = jax.tree.leaves(jpe.convert({k: v.numpy()
                                          for k, v in p0.items()}))
    for a, b, z in zip(jax.tree.leaves(_pe_tree(tt.model)), want, ref_p0):
        upd, ref = np.asarray(a) - np.asarray(z), np.asarray(b) - np.asarray(z)
        assert np.abs(upd - ref).max() <= 2 * hp["lr"] + 1e-6
        settled = np.abs(ref) > 0.9 * hp["lr"]
        np.testing.assert_allclose(upd[settled], ref[settled], atol=1e-6)


def test_pe_task_trains_and_loads_as_pe_ckpt(binarized, tmp_path,
                                             monkeypatch):
    """``run_task`` with the pe ``task_cls`` trains on the binarized split
    (finite losses, a checkpoint at the last step); that checkpoint, given
    as ``pe_ckpt``, loads in the port's Svc (``svc.pe`` is set: the loader
    swallows errors) with the trained weights and running statistics, and
    predicts what the task's model predicts."""
    tmp, hps = binarized
    hp = HParams(dict(hps["torch"], hidden_size=TINY_HP["hidden_size"],
                      task_cls=PE_TASK, work_dir=str(tmp / "work_pe"),
                      max_updates=3, val_check_interval=3, log_interval=1))
    trainer = run_task(hp, device="cpu")
    assert isinstance(trainer.task, PitchExtractionTask)
    losses = [h["loss"] for h in trainer.history]
    assert len(losses) == 3 and np.isfinite(losses).all()
    ckpt = ckpt_lib.latest_checkpoint(hp["work_dir"])
    assert ckpt.endswith("model_ckpt_steps_3.ckpt")
    monkeypatch.chdir(tmp_path)        # Svc keeps ./infer_tools caches
    cfg_fn, model = synth.write_project(
        str(tmp_path / "proj"), dict(TINY_HP, vocoder=NSF, pe_ckpt=ckpt),
        TINY_VOC)
    svc = Svc("proj", cfg_fn, False, model, device="cpu")
    assert svc.pe is not None
    trained = trainer.task.model.state_dict()
    for k, v in svc.pe.state_dict().items():
        assert torch.equal(v, trained[k].detach()), k
    bn = trainer.task.model.mel_prenet.layers[0][2]
    assert not torch.equal(bn.running_var.detach(),
                           torch.ones_like(bn.running_var))
    mel = torch.from_numpy(_pe_batch(np.random.RandomState(2))["mels"])
    torch.testing.assert_close(svc.pe(mel)["f0_denorm_pred"],
                               trainer.task.model(mel)["f0_denorm_pred"])


# -------------------------------------------------------------- --infer --

def _noise_of(batch):
    """The test items' start noise, shared by both packages."""
    seed = sum(map(ord, str(batch["item_name"][0])))
    return np.random.RandomState(seed).randn(
        *np.asarray(batch["mels"]).shape).astype(np.float32)


@pytest.mark.parametrize("vocoder", [False, True], ids=["mels_only",
                                                        "vocoder"])
def test_run_task_infer_matches_jax(binarized, tmp_path, monkeypatch,
                                    vocoder):
    """``run_task(infer=True)`` on a port checkpoint: every test item's
    ``[P]`` mel (``P_mels_npy``) against JAX's ``run_test`` on the same
    checkpoint (through JAX's reference converter), test split and start
    noise: PLMS at 2e-4 in the normalized mel (tests/test_torch_diffusion.py
    and the port's Svc-vs-JAX test), i.e. 7.5e-4 in the mel (half-range
    3.75).  Without vocoder weights only the mels are saved; with an
    NSF-HiFiGAN checkpoint each item also gets a finite, non-silent ``[P]``
    wav of its frames times hop and a png."""
    tmp, hps = binarized
    work = tmp_path / "work"
    extra = {"work_dir": str(work), "gen_dir_name": "t"}
    if vocoder:
        synth.write_nsf_generator(str(tmp_path / "voc"), TINY_VOC, seed=1)
        extra["vocoder_ckpt"] = str(tmp_path / "voc" / "model")
    hp = HParams(dict(hps["torch"], **extra))
    jt, state, tt = _tasks(HParams(dict(hps["jax"], **extra)), head_seed=6)
    path = ckpt_lib.save_checkpoint(str(work), tt.state_dict(), 0, 4)

    orig = SVCTask.sample
    monkeypatch.setattr(SVCTask, "sample", lambda self, batch, **kw: orig(
        self, batch, init_noise=torch.from_numpy(_noise_of(batch)), **kw))
    trainer = run_task(HParams(dict(hp, infer=True)), device="cpu")
    assert trainer.global_step == 4

    jwork = tmp_path / "jwork"
    jhp = HParams(dict(hps["jax"], work_dir=str(jwork), gen_dir_name="t"))
    params = convert_gaussian_diffusion(path, jhp)
    jt.sample = lambda p, batch, rng, speedup=None: jt.model.infer(
        p, jt.prepare_batch(batch, shard=False), rng,
        speedup=jhp["pndm_speedup"], init_noise=jnp.asarray(_noise_of(batch)))
    jrunner.run_test(jhp, jt, {"params": params}, None, global_step=4)

    names = sorted(os.listdir(jwork / "P_mels_npy"))
    assert names and sorted(os.listdir(work / "P_mels_npy")) == names
    for n in names:
        got, want = np.load(work / "P_mels_npy" / n), np.load(
            jwork / "P_mels_npy" / n)
        assert got.shape == want.shape
        assert (got >= hp["mel_vmin"]).all() and (got <= hp["mel_vmax"]).all()
        np.testing.assert_allclose(got, want, atol=7.5e-4, rtol=1e-4,
                                   err_msg=n)
    wavs = glob.glob(str(work / "generated_4_t" / "wavs" / "*.wav"))
    pngs = glob.glob(str(work / "generated_4_t" / "plot" / "*.png"))
    if not vocoder:
        assert wavs == [] and pngs == []
        return
    assert len(wavs) == len(pngs) == len(names)
    from diffsvc_tpu_torch.utils.audio_io import load_wav

    for n in names:
        wav, sr = load_wav(str(work / "generated_4_t" / "wavs" /
                               f"[P][{n[:-4]}].wav"))
        mel = np.load(work / "P_mels_npy" / n)
        assert sr == hp["audio_sample_rate"] and np.isfinite(wav).all()
        assert len(wav) == len(mel) * hp["hop_size"] and np.abs(wav).max() > 0
