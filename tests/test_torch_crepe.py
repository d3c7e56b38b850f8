"""CREPE in the torch port against the JAX package on the CPU, and the three
decisions the port settles as JAX does (ROADMAP Queue 3): CREPE without
weights falls back to the AC tracker (and only then), ``Svc`` and
``infer_cli`` ask for CREPE by default with only real CREPE tracks cached,
and ``process_item`` skips an item on any exception.

The weights are torchcrepe's ``full.pth`` layout written from a seed by
``utils/synth.write_crepe`` and read by both loaders.  Tolerances are
tests/test_crepe_fullchain.py's: frames 1e-5, posteriors 2e-5 (at most 32
frames: the network costs ~2.5 GFLOP a frame on each side), decode rtol 1e-4
(f0) / atol 1e-6 (periodicity), the whole chain's voicing exact and voiced
f0 rtol 2e-4.
"""

import inspect
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import (HOP, SR, TINY_HP, fake_units, voiced_wav,
                             write_project)
from diffsvc_tpu.config import HParams
from diffsvc_tpu.ops import crepe as jcrepe
from diffsvc_tpu_torch import infer_cli
from diffsvc_tpu_torch.data import features
from diffsvc_tpu_torch.infer import svc as tsvc_mod
from diffsvc_tpu_torch.ops import crepe as tcrepe
from diffsvc_tpu_torch.utils import synth


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    root = tmp_path_factory.mktemp("torch_crepe")
    cfg_fn, ckpt = write_project(str(root / "proj"))
    wav_fn = str(root / "in.wav")
    save_wav(voiced_wav(secs=0.5, f0=200.0), wav_fn, SR)
    return root, cfg_fn, ckpt, wav_fn


@pytest.fixture
def in_root(project, monkeypatch):
    monkeypatch.chdir(project[0])          # Svc keeps ./infer_tools caches
    return project


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("crepe") / "full.pth")
    synth.write_crepe(path, seed=4)
    return path, tcrepe.load_crepe(path), jcrepe.load_crepe(path)


def _wav16k(secs, seed=5):
    """A vibrato voice with a quiet gap and a noise floor at 16 kHz."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(16000 * secs)) / 16000
    ph = np.cumsum(2 * np.pi * 220.0 * 2 ** (0.05 * np.sin(2 * np.pi * 5 * t))
                   / 16000)
    wav = (0.4 * np.sin(ph) + 0.2 * np.sin(2 * ph)
           + 0.02 * rng.randn(len(t))).astype(np.float32)
    wav[int(0.45 * len(t)): int(0.55 * len(t))] *= 0.001
    return wav


def test_loader_reads_torchcrepe_layout(weights):
    """The file holds torchcrepe's names and shapes ([out, in, k, 1]
    convolutions, conv{i}_BN with running stats, classifier) and the port
    loads it into the same tensors."""
    path, model, _ = weights
    sd = torch.load(path, weights_only=True)
    for i, (f, k) in enumerate(zip(tcrepe.FILTERS, tcrepe.KERNELS), 1):
        c_in = 1 if i == 1 else tcrepe.FILTERS[i - 2]
        assert sd[f"conv{i}.weight"].shape == (f, c_in, k, 1)
        assert {f"conv{i}_BN.{n}" for n in ("weight", "bias", "running_mean",
                                            "running_var")} <= set(sd)
    assert sd["classifier.weight"].shape == (360, 2048)
    for k, v in model.state_dict().items():
        assert torch.equal(v, sd[k]), k


def test_network_matches_jax(weights):
    """32 frames: the z-scored frames (1e-5) and the posteriors (2e-5)."""
    _, model, params = weights
    wav = _wav16k(31 * 80 / 16000)
    frames = tcrepe.frame_audio(torch.from_numpy(wav))
    ref_frames = jcrepe.frame_audio(wav)
    assert frames.shape == ref_frames.shape == (32, 1024)
    np.testing.assert_allclose(frames.numpy(), ref_frames, atol=1e-5)
    got = tcrepe.posteriors(model, frames).numpy()
    ref = np.asarray(jcrepe.forward(params, jnp.asarray(ref_frames)))
    np.testing.assert_allclose(got, ref, atol=2e-5)


def test_posteriors_in_padded_chunks_equal_one_call(weights, monkeypatch):
    """The network in chunks of one shape, the last one padded with zero
    frames: the posteriors of one call on all frames."""
    _, model, _ = weights
    frames = tcrepe.frame_audio(torch.from_numpy(_wav16k(12 * 80 / 16000)))
    with torch.no_grad():
        ref = model(frames)
    monkeypatch.setattr(tcrepe, "FRAME_CHUNK", 8)
    got = tcrepe.posteriors(model, frames)
    assert got.shape == (13, 360)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-6)


def test_decode_matches_jax():
    """Viterbi + the cents window on 300 frames of peaked posteriors: f0
    rtol 1e-4, periodicity atol 1e-6, the path exact."""
    rng = np.random.RandomState(0)
    centre = 120 + 40 * np.sin(np.arange(300) / 20.0)
    bins = np.arange(360)[None, :]
    probs = (0.9 * np.exp(-0.5 * ((bins - centre[:, None]) / 3.0) ** 2)
             + 0.05 * rng.rand(300, 360)).astype(np.float32)
    f0, pd = tcrepe.decode(torch.from_numpy(probs))
    f0_j, pd_j = (np.asarray(a) for a in jcrepe.decode(jnp.asarray(probs)))
    np.testing.assert_array_equal(
        tcrepe._viterbi(torch.from_numpy(probs)).numpy(),
        np.asarray(jcrepe._viterbi(jnp.asarray(probs))))
    np.testing.assert_allclose(f0.numpy(), f0_j, rtol=1e-4)
    np.testing.assert_allclose(pd.numpy(), pd_j, atol=1e-6)


def test_full_chain_matches_jax(weights):
    """get_pitch_crepe on 0.3 s (61 frames), mel grid of hop 160: voicing
    exact, voiced f0 rtol 2e-4, coarse bins equal."""
    _, model, params = weights
    wav = _wav16k(0.3)
    hp = dict(audio_sample_rate=16000, hop_size=160, f0_bin=256, f0_min=40.0,
              f0_max=1100.0)
    mel = np.zeros((len(wav) // 160 + 1, 8), np.float32)
    got, coarse = tcrepe.get_pitch_crepe(wav, mel, hp, model=model)
    ref, ref_coarse = jcrepe.get_pitch_crepe(wav, mel, HParams(**hp),
                                             params=params)
    assert got.shape == ref.shape == (len(mel),)
    np.testing.assert_array_equal(got > 0, ref > 0)
    assert (ref > 0).any()
    v = ref > 0
    np.testing.assert_allclose(got[v], ref[v], rtol=2e-4)
    np.testing.assert_array_equal(coarse, ref_coarse)


def test_filters_match_jax():
    x = np.array([np.nan, 1.0, 5.0, np.nan, np.nan, 2.0, 3.0, 9.0, np.nan])
    np.testing.assert_array_equal(tcrepe.median_filter(x),
                                  jcrepe.median_filter(x))
    np.testing.assert_array_equal(tcrepe.mean_filter(x),
                                  jcrepe.mean_filter(x))
    wav = _wav16k(0.2)
    np.testing.assert_allclose(tcrepe.a_weighted_loudness(wav),
                               jcrepe.a_weighted_loudness(wav), atol=1e-5)


# ---------------------------------------------------------------------------
# Step 0: the differences settled as JAX does
# ---------------------------------------------------------------------------

def test_crepe_falls_back_to_ac_only_without_weights(weights, capsys,
                                                     monkeypatch):
    """No weights: JAX's line, the AC track, tag 'ac'.  With weights: CREPE,
    tag 'crepe'.  Any other error (a device or launch error, a corrupt
    file) raises."""
    path, _, _ = weights
    wav = voiced_wav(secs=0.3)
    mel = np.zeros((1 + len(wav) // HOP, 16), np.float32)
    hp = dict(TINY_HP, crepe_path="/nonexistent/full.pth")
    f0, coarse, tag = features.get_pitch(wav, mel, hp, True, return_tag=True)
    assert tag == "ac"
    assert "| crepe unavailable (no crepe weights at /nonexistent/full.pth);" \
           " falling back to AC tracker" in capsys.readouterr().out
    ac = features.get_pitch(wav, mel, hp, False)
    np.testing.assert_array_equal(f0, ac[0])
    np.testing.assert_array_equal(coarse, ac[1])
    _, _, tag = features.get_pitch(wav, mel, dict(TINY_HP, crepe_path=path),
                                   True, return_tag=True)
    assert tag == "crepe"

    def launch_error(*a, **k):
        raise RuntimeError("CUDA error: an illegal memory access")

    monkeypatch.setattr(tcrepe, "get_pitch_crepe", launch_error)
    with pytest.raises(RuntimeError, match="CUDA error"):
        features.get_pitch(wav, mel, hp, True)
    monkeypatch.undo()
    bad = os.path.join(os.path.dirname(path), "corrupt.pth")
    with open(bad, "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(Exception) as err:
        features.get_pitch(wav, mel, dict(TINY_HP, crepe_path=bad), True)
    assert not isinstance(err.value, (ImportError, FileNotFoundError))


def test_crepe_is_the_default_and_only_real_tracks_are_cached(
        in_root, weights, monkeypatch):
    """Svc.infer / infer_batched / pre default to use_crepe=True, as JAX's;
    infer_cli runs CREPE unless --no_crepe (--crepe is accepted); the md5
    f0 cache keeps a CREPE track and never an AC fallback."""
    for fn in (tsvc_mod.Svc.infer, tsvc_mod.Svc.infer_batched,
               tsvc_mod.Svc.pre):
        assert inspect.signature(fn).parameters["use_crepe"].default is True
    _, cfg_fn, ckpt, wav_fn = in_root
    svc = tsvc_mod.Svc("proj", cfg_fn, False, ckpt, device="cpu")
    svc.hubert.encode = fake_units
    short = "short.wav"
    from diffsvc_tpu_torch.utils.audio_io import save_wav

    save_wav(voiced_wav(secs=0.3), short, SR)
    svc.hp["crepe_path"] = "/nonexistent/full.pth"
    svc.pre(short, 10)
    assert not any(k.endswith("_gt") for k in svc.f0_dict)
    svc.hp["crepe_path"] = weights[0]
    b = svc.pre(short, 10)
    keys = [k for k in svc.f0_dict if k.endswith("_gt")]
    assert len(keys) == 1
    cached = np.array(svc.f0_dict[keys[0]]["f0"], np.float32)
    assert (cached > 0).any() and b["f0"].shape[1] >= len(cached)
    seen = []
    monkeypatch.setattr(infer_cli, "run_clip",
                        lambda *a, **k: seen.append(k["use_crepe"]))
    base = ["--project", "proj", "--model", ckpt, "--config", cfg_fn,
            "--files", wav_fn, "--acc", "10", "--device", "cpu"]
    for flags in ([], ["--crepe"], ["--no_crepe"]):
        infer_cli.main(base + flags)
    assert seen == [True, True, False]


def test_process_item_skips_on_any_exception(capsys):
    """Any exception skips the item with its message (JAX's
    ``except Exception``), not only ValueError / OSError."""
    def boom(_):
        raise RuntimeError("encoder exploded")

    wav = voiced_wav(secs=0.3)
    item = features.process_item("x", wav, dict(
        TINY_HP, vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN"), boom)
    assert item is None
    assert "| Skip item (encoder exploded). item_name: x" in \
        capsys.readouterr().out
