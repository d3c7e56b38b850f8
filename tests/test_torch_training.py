"""The port's training slice against the JAX package, on the CPU: the
binarizer, the batches, one SVCTask step, the schedulers, accumulation and
EMA, the checkpoints and the trainer's resume.

The fixture is ``tests/test_training.py``'s (8 kHz, 16 mel bins, DiffNet
32 x 4, hidden 256) with the NSF-HiFiGAN front end (the one the port has)
and the same deterministic stand-in for the HuBERT units on both sides.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from _torch_fixtures import fake_units
from diffsvc_tpu.config import HParams
from diffsvc_tpu.data.binarizer import SVCBinarizer as JBinarizer
from diffsvc_tpu.data.dataset import FastSpeechDataset as JDataset
from diffsvc_tpu.data.dataset import build_batches as jbuild_batches
from diffsvc_tpu.training import scheduler as jsched
from diffsvc_tpu.training.task import SVCTask as JTask
from diffsvc_tpu.utils.audio_io import save_wav
from diffsvc_tpu_torch.data.binarizer import SVCBinarizer, binarize
from diffsvc_tpu_torch.data.dataset import (BatchIterator, FastSpeechDataset,
                                            build_batches)
from diffsvc_tpu_torch.data.indexed_datasets import IndexedDataset
from diffsvc_tpu_torch.models.diffusion import GaussianDiffusion
from diffsvc_tpu_torch.run import run_task
from diffsvc_tpu_torch.training import checkpoint as ckpt_lib
from diffsvc_tpu_torch.training import scheduler
from diffsvc_tpu_torch.training.task import RAdam, SVCTask
from diffsvc_tpu_torch.training.trainer import Trainer
from diffsvc_tpu_torch.utils.convert import (diffusion_jax_to_torch,
                                             load_ckpt_state_dict,
                                             load_reference_state)

MEL = 16
HID = 256


def _hp(tmp, tag, **kw):
    hp = HParams(
        audio_sample_rate=8000, audio_num_mel_bins=MEL, fft_size=256,
        hop_size=64, win_size=256, fmin=30, fmax=4000, wav2spec_eps=1e-6,
        hidden_size=HID, residual_layers=4, residual_channels=32,
        dilation_cycle_length=4, timesteps=20, K_step=20,
        diff_loss_type="l2", schedule_type="linear", max_beta=0.02,
        keep_bins=MEL, spec_min=[-6.0], spec_max=[1.5],
        no_fs2=True, use_pitch_embed=True, use_energy_embed=False,
        use_spk_id=False, use_spk_embed=False, use_uv=False,
        pitch_norm="log", f0_bin=256, f0_min=50.0, f0_max=1100.0,
        use_crepe=False, use_vec=False, use_nsf=True,
        vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN",
        raw_data_dir=str(tmp / "raw"), binary_data_dir=str(tmp / f"bin_{tag}"),
        work_dir=str(tmp / f"work_{tag}"), speaker_id="tester", num_spk=1,
        choose_test_manually=False, test_prefixes=[],
        hubert_path=str(tmp / "nohubert"),
        binarization_args=dict(with_f0=True, with_hubert=True,
                               with_align=True, with_wav=False, shuffle=False),
        lr=1e-3, scheduler="step_lr", decay_steps=100,
        optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98, weight_decay=0,
        clip_grad_norm=1, accumulate_grad_batches=1,
        max_updates=10, max_epochs=100, max_tokens=4000, max_sentences=8,
        max_eval_tokens=4000, max_eval_sentences=1, max_frames=42000,
        max_input_tokens=60000, frames_multiple=32, endless_ds=False,
        sort_by_len=True, seed=1234, num_sanity_val_steps=1,
        val_check_interval=5, num_valid_plots=0, log_interval=2,
        num_ckpt_keep=2, save_best=False, load_ckpt="", debug=False,
        config_path=str(tmp / f"cfg_{tag}.yaml"), pndm_speedup=5,
        mel_vmin=-6.0, mel_vmax=1.5, infer=False, task_cls="SVCTask",
        diffnet_train_stream_dtype="f32", wav_bucket_frames=128,
    )
    hp.update(kw)
    return hp


class _Units:
    def encode(self, wav_fn):
        return fake_units(wav_fn, dim=HID)


@pytest.fixture(scope="module")
def binarized(tmp_path_factory):
    """The same raw clips binarized by both packages."""
    tmp = tmp_path_factory.mktemp("torch_train")
    os.makedirs(tmp / "raw")
    sr = 8000
    for i in range(8):
        t = np.arange(int(sr * (0.4 + 0.15 * i))) / sr
        wav = 0.4 * np.sin(2 * np.pi * (150 + 30 * i) * t).astype(np.float32)
        save_wav(wav, str(tmp / "raw" / f"item{i}.wav"), sr)
    hps = {}
    for tag in ("jax", "torch"):
        hp = hps[tag] = _hp(tmp, tag)
        with open(hp["config_path"], "w") as f:
            yaml.safe_dump({k: v for k, v in hp.items() if isinstance(
                v, (int, float, str, bool, list, dict))}, f)
    jb = JBinarizer(hps["jax"])
    jb._phone_encoder = _Units
    jb.process()
    tb = SVCBinarizer(hps["torch"])
    tb._phone_encoder = _Units
    tb.process()
    return tmp, hps


def test_binarizer_matches_jax(binarized):
    """Item by item, every split: names, lengths, units, mel2ph and pitch
    equal; mel within 1e-4 (relative and absolute) and f0 within 1e-4 Hz
    (the front end's tolerances in tests/test_torch_frontend.py); the spec
    stats written back to each config within 1e-4."""
    _, hps = binarized
    dj, dt = hps["jax"]["binary_data_dir"], hps["torch"]["binary_data_dir"]
    for prefix in ("train", "valid", "test"):
        np.testing.assert_array_equal(np.load(f"{dt}/{prefix}_lengths.npy"),
                                      np.load(f"{dj}/{prefix}_lengths.npy"))
        a, b = IndexedDataset(f"{dt}/{prefix}"), IndexedDataset(f"{dj}/{prefix}")
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            x, y = a[i], b[i]
            assert x["item_name"] == y["item_name"]
            assert x["len"] == y["len"] and "wav" not in x
            for k in ("hubert", "mel2ph", "pitch"):
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            np.testing.assert_allclose(x["mel"], y["mel"], rtol=1e-4,
                                       atol=1e-4)
            np.testing.assert_allclose(x["f0"], y["f0"], atol=1e-4)
    assert len(np.load(f"{dt}/train_lengths.npy")) == 3
    cj = yaml.safe_load(open(hps["jax"]["config_path"]))
    ct = yaml.safe_load(open(hps["torch"]["config_path"]))
    for k in ("spec_min", "spec_max"):
        assert len(ct[k]) == MEL
        np.testing.assert_allclose(ct[k], cj[k], atol=1e-4)


def test_build_batches_match_jax(binarized):
    """The same seed gives the same index batches and the same collated
    arrays."""
    _, hps = binarized
    for seed in (0, 7):
        tds = FastSpeechDataset("train", hps["torch"], shuffle=True)
        jds = JDataset("train", hps["jax"], shuffle=True)
        got = build_batches(tds, hps["torch"],
                            rng=np.random.RandomState(seed))
        want = jbuild_batches(jds, hps["jax"],
                              rng=np.random.RandomState(seed))
        assert got == want and sum(map(len, got)) == 3
    batch = next(iter(BatchIterator(tds, got, pad_multiple=32)))
    ref = jds.collater([jds[i] for i in got[0]], pad_multiple=32)
    assert batch["mels"].shape[1] % 32 == 0
    for k in ("hubert", "mel2ph", "pitch", "uv"):
        np.testing.assert_array_equal(batch[k], ref[k], err_msg=k)
    for k in ("mels", "f0", "energy"):
        np.testing.assert_allclose(batch[k], ref[k], atol=1e-3, err_msg=k)


def _jax_draws(task, batch, step, seed=0):
    """t and noise exactly as the JAX step draws them."""
    rng = jax.random.fold_in(jax.random.PRNGKey(seed), step)
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (batch["mels"].shape[0],), 0,
                           task.model.cfg.K_step)
    noise = jax.random.normal(n_rng, batch["mels"].shape, jnp.float32)
    return rng, torch.from_numpy(np.asarray(t)), \
        torch.from_numpy(np.asarray(noise))


def _tasks(hp, head_seed=None):
    """The JAX and the port task from the same (JAX-initialized) params; a
    ``head_seed`` draws a nonzero output head (a zero head zeroes every
    gradient inside the denoiser)."""
    jt = JTask(hp)
    state = jt.init_state()
    if head_seed is not None:
        op = state["params"]["denoise_fn"]["output_projection"]
        op["w"] = jnp.asarray(np.random.RandomState(head_seed).randn(
            *op["w"].shape).astype(np.float32) * 0.2)
        state["opt_state"] = jt.tx.init(state["params"])
    tt = SVCTask(hp, device="cpu")
    tt.model.load_state_dict(diffusion_jax_to_torch(
        jax.tree.map(np.asarray, state["params"])))
    return jt, state, tt


def _torch_sd(params):
    return {k: v.numpy() for k, v in diffusion_jax_to_torch(
        jax.tree.map(np.asarray, params)).items()}


@pytest.mark.parametrize("stream,tol_loss,tol_grad", [
    ("f32", 1e-5, 1e-3), ("bf16", 1e-5, 1e-3)])
def test_train_step_matches_jax(binarized, stream, tol_loss, tol_grad):
    """One step from the same params, batch, t and noise: loss, grad_norm,
    every gradient and the updated params.  The fixture's C = 32 is not a
    multiple of 128, so for either ``diffnet_train_stream_dtype`` the JAX
    step runs the f32 scan, and the port takes the same route
    (``diffnet.train_route`` -> "scan": K4's plain versions at the f32
    stream), so both streams get the scan's f32 tolerances.  (Before the
    route rule the port streamed bf16 here: loss 1.539638996 against JAX's
    1.537837625.)  AdamW's first update is about
    -lr * sign(g), so params are compared where |g| is above the gradient
    tolerance (the sign is settled there) to 1e-6, and everywhere to
    2 lr."""
    _, hps = binarized
    hp = HParams(dict(hps["jax"], diffnet_train_stream_dtype=stream))
    jt, state, tt = _tasks(hp, head_seed=3)
    ds = JDataset("train", hp, shuffle=False)
    batch = ds.collater([ds[i] for i in range(len(ds))], pad_multiple=32)
    rng, t, noise = _jax_draws(jt, batch, 0)
    jb = jt.prepare_batch(batch)
    gj = jax.grad(lambda p: jt.model.training_loss(p, jb, rng)[0])(
        state["params"])
    p0 = _torch_sd(state["params"])
    new_state, mj = jt.train_step(state, batch, jax.random.PRNGKey(0))

    loss, _ = tt.model.training_loss(tt.prepare_batch(batch), t=t,
                                     noise=noise)
    gt = torch.autograd.grad(loss, tt.params, allow_unused=True)
    mt = tt.train_step(batch, t=t, noise=noise)
    np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                               rtol=tol_loss)
    np.testing.assert_allclose(float(mt["grad_norm"]), float(mj["grad_norm"]),
                               rtol=tol_grad)
    assert mt["lr"] == pytest.approx(float(mj["lr"]), rel=1e-6)
    want_g, want_p = _torch_sd(gj), _torch_sd(new_state["params"])
    got_p = tt.model.state_dict()
    lr = hp["lr"]
    for name, g in zip(tt.names, gt):
        ref = want_g[name]
        g = np.zeros_like(ref) if g is None else g.numpy()
        scale = np.abs(ref).max()
        assert np.abs(g - ref).max() <= tol_grad * scale + 1e-12, name
        upd, upd_ref = got_p[name].numpy() - p0[name], want_p[name] - p0[name]
        assert np.abs(upd - upd_ref).max() <= 2 * lr + 1e-6, name
        settled = np.abs(ref) > tol_grad * scale
        np.testing.assert_allclose(upd[settled], upd_ref[settled], atol=1e-6,
                                   err_msg=name)


def test_schedulers_match_jax():
    for s_t, s_j in ((scheduler.step_lr_schedule(1e-3, 10),
                      jsched.step_lr_schedule(1e-3, 10)),
                     (scheduler.rsqrt_schedule(1e-3, 100, 256),
                      jsched.rsqrt_schedule(1e-3, 100, 256))):
        for step in (0, 1, 9, 10, 25, 50, 100, 400):
            assert s_t(step) == pytest.approx(
                float(s_j(jnp.asarray(step, jnp.int32))), rel=1e-6)


def test_accumulation_matches_jax_multisteps(binarized):
    """accumulate_grad_batches=2: no update on the first micro-step, then
    one AdamW step on the mean of the two grads at lr(0); the lr metric
    reads the optimizer step (optax.MultiSteps semantics).  f32 streams;
    params compared as in test_train_step_matches_jax."""
    _, hps = binarized
    hp = HParams(dict(hps["jax"], accumulate_grad_batches=2,
                      scheduler="step_lr", decay_steps=1))
    jt, state, tt = _tasks(hp, head_seed=4)
    ds = JDataset("train", hp, shuffle=False)
    batch = ds.collater([ds[i] for i in range(len(ds))], pad_multiple=32)
    p0 = _torch_sd(state["params"])
    lrs = []
    for step in range(2):
        _, t, noise = _jax_draws(jt, batch, step)
        state, mj = jt.train_step(state, batch, jax.random.PRNGKey(0))
        mt = tt.train_step(batch, t=t, noise=noise)
        lrs.append((mt["lr"], float(mj["lr"])))
        if step == 0:
            for name, v in tt.model.state_dict().items():
                np.testing.assert_array_equal(v.numpy(), p0[name])
    assert lrs[0][0] == lrs[1][0] == pytest.approx(lrs[1][1]) == 1e-3
    assert tt.opt_steps == 1 and tt.step == 2 and tt.acc is None
    want = _torch_sd(state["params"])
    moved = 0
    for name, v in tt.model.state_dict().items():
        upd, ref = v.numpy() - p0[name], want[name] - p0[name]
        assert np.abs(upd - ref).max() <= 2e-3 + 1e-6, name
        settled = np.abs(ref) > 0.9e-3     # |update| ~ lr where settled
        np.testing.assert_allclose(upd[settled], ref[settled], atol=1e-6)
        moved += int(settled.sum())
    assert moved > 0


def test_ema_tracks_the_params(binarized):
    """ema_decay: after each step ema = d * ema + (1 - d) * params, as the
    JAX task; the EMA weights ride in the checkpoint and are the ones
    load_params_for_infer returns."""
    tmp, hps = binarized
    hp = HParams(dict(hps["torch"], ema_decay=0.5))
    tt = SVCTask(hp, device="cpu")
    ds = FastSpeechDataset("train", hp, shuffle=False)
    batch = ds.collater([ds[0], ds[1]], pad_multiple=32)
    e0 = {k: v.clone() for k, v in tt.ema.state_dict().items()}
    tt.train_step(batch)
    for k, v in tt.model.state_dict().items():
        torch.testing.assert_close(tt.ema.state_dict()[k],
                                   0.5 * e0[k] + 0.5 * v, rtol=0, atol=0)
    path = ckpt_lib.save_checkpoint(str(tmp / "ema_ckpt"), tt.state_dict(),
                                    0, 1)
    got = ckpt_lib.load_params_for_infer(path)
    for k, v in tt.ema.state_dict().items():
        assert torch.equal(got[k], v)


def test_first_loss_near_one_and_radam_raises(binarized):
    """The JAX init (zero output head; pitch embedding N(0, hidden^-0.5)
    with a zero padding row) makes the first l2 loss ~E[noise^2].
    Optimizer radam is ported (optax's update, tests/test_torch_train_rest.py
    holds it against optax); what still raises is an unknown optimizer."""
    _, hps = binarized
    hp = HParams(dict(hps["torch"]))
    tt = SVCTask(hp, device="cpu")
    ds = FastSpeechDataset("train", hp, shuffle=False)
    pe = tt.model.fs2.pitch_embed.weight
    assert float(pe[0].abs().max()) == 0.0      # padding row
    assert abs(float(pe[1:].std()) * HID ** 0.5 - 1.0) < 0.05
    m = tt.train_step(ds.collater([ds[i] for i in range(3)], pad_multiple=32))
    assert 0.5 < float(m["loss"]) < 2.0
    radam = SVCTask(HParams(dict(hp, optimizer="radam")), device="cpu")
    assert isinstance(radam.optimizer, RAdam)
    with pytest.raises(ValueError):
        SVCTask(HParams(dict(hp, optimizer="sgdx")), device="cpu")


def test_print_nan_grads(binarized, capfd):
    _, hps = binarized
    hp = HParams(dict(hps["torch"], print_nan_grads=True))
    tt = SVCTask(hp, device="cpu")
    ds = FastSpeechDataset("train", hp, shuffle=False)
    batch = ds.collater([ds[0]], pad_multiple=32)
    batch["mels"] = np.full_like(batch["mels"], np.nan)
    assert not np.isfinite(float(tt.train_step(batch)["loss"]))
    assert "non-finite grad" in capfd.readouterr().out


def test_checkpoint_keep_k_best_and_atomic(tmp_path):
    state = {"state_dict": {"model.w": torch.ones(3)}}
    for step, val in [(1, 1.0), (2, 0.5), (3, 0.7), (4, 0.4)]:
        ckpt_lib.save_checkpoint(str(tmp_path), state, 0, step,
                                 num_ckpt_keep=2, save_best=True,
                                 monitor_value=val)
    kept = sorted(glob.glob(str(tmp_path / "model_ckpt_steps_*.ckpt")))
    assert [os.path.basename(k) for k in kept] == [
        "model_ckpt_steps_3.ckpt", "model_ckpt_steps_4.ckpt"]
    assert os.path.exists(tmp_path / "model_ckpt_best.pt")
    assert float(np.load(tmp_path / "best_valid.npy")[0]) == 0.4
    assert not glob.glob(str(tmp_path / "*.part"))
    ckpt, epoch, step, _ = ckpt_lib.restore_checkpoint(str(tmp_path))
    assert (epoch, step) == (0, 4) and torch.equal(ckpt["state_dict"]["model.w"],
                                                   torch.ones(3))
    slim = str(tmp_path / "slim.ckpt")
    ckpt_lib.simplify_checkpoint(kept[-1], slim)
    assert set(torch.load(slim, weights_only=False)) == {
        "state_dict", "epoch", "global_step"}


def test_trainer_fit_and_resume(binarized):
    """fit to step 6 (validation and a checkpoint at steps 3 and 6), then a
    second trainer resumes to step 8: the same step counts and checkpoints
    as tests/test_training.py:210-235, and the restored state equals the
    saved one bit for bit (params and optimizer)."""
    tmp, hps = binarized
    hp = HParams(dict(hps["torch"], work_dir=str(tmp / "work_fit"),
                      max_updates=6, val_check_interval=3))
    t1 = Trainer(hp, log_writer=False, device="cpu")
    t1.fit()
    assert t1.global_step == 6
    names = sorted(os.path.basename(p) for p in
                   glob.glob(os.path.join(hp["work_dir"], "*.ckpt")))
    assert names == ["model_ckpt_steps_3.ckpt", "model_ckpt_steps_6.ckpt"]
    saved = t1.task.state_dict()

    t2 = Trainer(HParams(dict(hp, max_updates=8)), log_writer=False,
                 device="cpu")
    assert t2.restore() and t2.global_step == 6 and t2.task.step == 6
    for k, v in saved["state_dict"].items():
        assert torch.equal(t2.task.state_dict()["state_dict"][k], v), k
    o1, o2 = saved["optimizer_states"][0], t2.task.optimizer.state_dict()
    for i, st in o1["state"].items():
        for k, v in st.items():
            assert torch.equal(o2["state"][i][k].cpu(), v.cpu()), (i, k)
    t2.fit()
    assert t2.global_step == 8
    latest = ckpt_lib.latest_checkpoint(hp["work_dir"])
    assert latest.endswith("model_ckpt_steps_8.ckpt")
    assert torch.load(latest, weights_only=False)["global_step"] == 8

    # the port's Svc loads a trained checkpoint through the reference loader
    model = GaussianDiffusion(hp)
    load_reference_state(model, load_ckpt_state_dict(latest))
    for k, v in t2.task.model.state_dict().items():
        assert torch.equal(model.state_dict()[k], v), k

    # --validate through the entry point (--infer: test_torch_train_rest.py);
    # a vocoder task_cls goes to train_vocoder, which refuses items binarized
    # without their waveforms
    t3 = run_task(HParams(dict(hp, validate=True)), device="cpu")
    assert t3.global_step == 8
    with pytest.raises(ValueError, match="with_wav"):
        run_task(HParams(dict(hp, task_cls="training.task.vocoder."
                                  "HifiGanTask")), device="cpu")

    # load_ckpt warm-starts a fresh work dir from the trained weights
    t4 = Trainer(HParams(dict(hp, work_dir=str(tmp / "work_warm"),
                              load_ckpt=latest)), log_writer=False,
                 device="cpu")
    assert not t4.restore() and t4.global_step == 0
    for k, v in t2.task.model.state_dict().items():
        assert torch.equal(t4.task.model.state_dict()[k], v), k


class _Writer:
    """Records what the trainer logs (stands in for TensorBoard)."""

    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append(("scalar", tag, step))

    def add_figure(self, tag, fig, step):
        self.calls.append(("figure", tag, step))


def test_validate_logs_and_plots_with_a_writer(binarized):
    """With a writer, validation logs val/loss and samples the first
    ``num_valid_plots`` batches through K2 with the EMA weights (the JAX
    trainer's _plot_validation); without one it samples nothing."""
    tmp, hps = binarized
    hp = HParams(dict(hps["torch"], work_dir=str(tmp / "work_plot"),
                      num_valid_plots=1, ema_decay=0.9))
    writer = _Writer()
    tr = Trainer(hp, log_writer=writer, device="cpu")
    loss = tr.validate(FastSpeechDataset("valid", hp, shuffle=False), 32)
    assert np.isfinite(loss)
    assert ("figure", "mel_0", 0) in writer.calls
    assert ("scalar", "val/loss", 0) in writer.calls
    out = tr.task.sample(next(iter(tr._val_batches(
        FastSpeechDataset("valid", hp, shuffle=False), 32))))
    assert torch.isfinite(out["mel_out"]).all()


def test_binarize_entry_rejects_other_binarizers(binarized):
    _, hps = binarized
    with pytest.raises(NotImplementedError, match="binarizer_cls"):
        binarize(HParams(dict(hps["torch"],
                              binarizer_cls="preprocessing.x.OtherBinarizer")),
                 device="cpu")
