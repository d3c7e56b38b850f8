"""The port's fused serving program and its device front end against the
JAX package on the CPU: the polyphase resampler, the associative-scan
Viterbi and the device tracker, the alignment and f0 interpolation, and
``FusedSvc`` (single chunk and batched) on a tiny project, where both
sides get the same sampler noise and NSF source draws (JAX's, reproduced
from its key) and the vocoder runs its plain path on both."""

import io
import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile
from scipy.signal import resample_poly

from _torch_fixtures import (HID, HOP, SR, TINY_HP, fake_units, voiced_wav,
                             write_project)
from diffsvc_tpu.data.features import get_align_uniform
from diffsvc_tpu.infer.fused import FusedSvc as JFusedSvc
from diffsvc_tpu.infer.fused import norm_interp_f0_device as j_interp
from diffsvc_tpu.infer.svc import Svc as JSvc
from diffsvc_tpu.models import hubert as jhubert
from diffsvc_tpu.ops import f0_ac as jf0
from diffsvc_tpu.ops.pitch import norm_interp_f0_np
from diffsvc_tpu.ops.resample import resample_poly_device as j_resample
from diffsvc_tpu_torch.data import features as tfeat
from diffsvc_tpu_torch.infer import hubert_encoder
from diffsvc_tpu_torch.infer.fused import (FusedSvc, align_uniform_device,
                                           norm_interp_f0_device)
from diffsvc_tpu_torch.infer.svc import Svc as TSvc
from diffsvc_tpu_torch.models.hubert import HubertConfig
from diffsvc_tpu_torch.ops import f0_ac as tf0
from diffsvc_tpu_torch.ops.resample import (resample_length,
                                            resample_poly_device)
from diffsvc_tpu_torch.utils.synth import write_hubert
from diffsvc_tpu_torch.vocoders.generator import draw_randoms

HUB = dict(dim=32, num_heads=2, num_layers=2, ffn_dim=64, proj_dim=HID)
ACC = 10


# ---------------------------------------------------------------------------
# resampler
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pair", [(44100, 16000), (24000, 16000)],
                         ids=["44k", "24k"])
@pytest.mark.parametrize("n", [44100, 44101, 12345])
def test_resample_matches_jax_and_scipy(n, pair):
    """Against JAX's device resampler to 1e-5 and scipy's resample_poly to
    3e-5 (tests/test_fused.py's limit), odd lengths included."""
    x = np.random.RandomState(n).randn(n).astype(np.float32)
    got = resample_poly_device(torch.from_numpy(x), *pair).numpy()
    ref_j = np.asarray(j_resample(x, *pair))
    g = math.gcd(*pair)
    ref_s = resample_poly(x.astype(np.float64), pair[1] // g,
                          pair[0] // g).astype(np.float32)
    assert got.shape == ref_j.shape == ref_s.shape == (
        resample_length(n, *pair),)
    np.testing.assert_allclose(got, ref_j, atol=1e-5)
    np.testing.assert_allclose(got, ref_s, atol=3e-5)


def test_resample_batched_rows_equal_single():
    x = np.random.RandomState(1).randn(3, 4410).astype(np.float32)
    rows = resample_poly_device(torch.from_numpy(x), 44100, 16000)
    for i in range(3):
        np.testing.assert_array_equal(rows[i].numpy(), resample_poly_device(
            torch.from_numpy(x[i]), 44100, 16000).numpy())


# ---------------------------------------------------------------------------
# the device tracker
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("reverse", [False, True], ids=["fwd", "rev"])
@pytest.mark.parametrize("n", [1, 2, 7, 16, 33])
def test_associative_scan_matches_jax(n, reverse):
    """The combine order is JAX's: a non-commutative combine (2x2 integer
    matrix products) gives JAX's result exactly, in both directions."""
    rng = np.random.RandomState(n)
    m = rng.randint(-2, 3, size=(n, 2, 2)).astype(np.int64)
    ref = np.asarray(jax.lax.associative_scan(
        lambda a, b: jnp.einsum("...ij,...jk->...ik", a, b), jnp.asarray(m),
        reverse=reverse))
    got = tf0.associative_scan(lambda a, b: a @ b, torch.from_numpy(m),
                               dim=0, reverse=reverse).numpy()
    np.testing.assert_array_equal(got, ref)


def _candidates(f0):
    """(freq, strength) [T, 15] of the tiny project's tracker on a voiced
    wav with a silence, from the port (held to JAX's below)."""
    wav = voiced_wav(secs=1.2, f0=f0, gaps=[(0.5, 0.7)])
    g = tf0.frame_grid(len(wav), SR, HOP, 40.0)
    w = torch.from_numpy(wav)
    r, lp = tf0._frame_acf(w, hop=HOP, **{k: g[k] for k in (
        "n_frames", "win_samples", "fft_size", "start0")})
    gp = (w - w.mean()).abs().amax()
    return tf0._find_candidates(r, lp, gp, float(SR), 40.0, 1100.0, 0.6)


@pytest.mark.parametrize("f0", [110.0, 220.0, 440.0])
def test_viterbi_matches_jax_on_voiced_candidates(f0):
    """The same path as JAX's ``_viterbi`` (and its sequential scan) on the
    candidates of a voiced wav."""
    cf, cs = _candidates(f0)
    tsc = 0.01 / (HOP / SR)
    got = tf0._viterbi(cf, cs, tsc).numpy()
    ref = np.asarray(jf0._viterbi(jnp.asarray(cf.numpy()),
                                  jnp.asarray(cs.numpy()), tsc))
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        got, tf0._viterbi_seq(cf.numpy(), cs.numpy(), tsc))
    assert (cf.numpy()[np.arange(len(got)), got] > 0).mean() > 0.5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_equals_sequential_on_random_strengths(seed):
    """Tie-free random strengths and frequencies (some unvoiced), batched:
    each row's path equals the sequential dynamic program's."""
    rng = np.random.RandomState(seed)
    b, t, k = 3, 57, tf0.MAX_CANDIDATES
    freq = rng.uniform(60, 900, size=(b, t, k)).astype(np.float32)
    freq[:, :, 0] = 0.0
    freq[rng.rand(b, t, k) < 0.1] = 0.0
    strength = rng.uniform(0, 1, size=(b, t, k)).astype(np.float32)
    got = tf0._viterbi(torch.from_numpy(freq), torch.from_numpy(strength),
                       1.0).numpy()
    for i in range(b):
        np.testing.assert_array_equal(
            got[i], tf0._viterbi_seq(freq[i], strength[i], 1.0))


def test_viterbi_single_frame():
    s = torch.tensor([[0.1, 0.7, 0.3]])
    f = torch.tensor([[0.0, 200.0, 400.0]])
    assert tf0._viterbi(f, s, 1.0).tolist() == [1]
    assert tf0._viterbi(f[None].expand(2, 1, 3), s[None].expand(2, 1, 3),
                        1.0).tolist() == [[1], [1]]


@pytest.mark.parametrize("f0", [110.0, 330.0])
def test_track_batched_matches_jax(f0):
    """The device pass over a batch of two wavs: each row's f0 equals
    JAX's ``_track`` on that wav (voicing exact; f0 to
    test_torch_frontend.py's tolerances)."""
    wavs = np.stack([voiced_wav(secs=1.0, f0=f0, gaps=[(0.4, 0.6)]),
                     voiced_wav(secs=1.0, f0=f0 * 1.5, seed=3)])
    got = tf0.track(torch.from_numpy(wavs), sr=SR, hop=HOP, f0_min=40.0,
                    f0_max=1100.0).numpy()
    g = tf0.frame_grid(wavs.shape[1], SR, HOP, 40.0)
    for i in range(2):
        ref = np.asarray(jf0._track(
            jnp.asarray(wavs[i]), sr=SR, hop=HOP, n_frames=g["n_frames"],
            win_samples=g["win_samples"], fft_size=g["fft_size"],
            start0=g["start0"], f0_min=40.0, f0_max=1100.0,
            voicing_threshold=0.6, tsc=0.01 / (HOP / SR)))
        np.testing.assert_array_equal(got[i] > 0, ref > 0)
        v = ref > 0
        rel = np.abs(got[i][v] - ref[v]) / ref[v]
        assert (rel <= 1e-4).mean() >= 0.97 and rel.max() <= 5e-3


# ---------------------------------------------------------------------------
# alignment and f0 interpolation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mel_len,n_units", [(10, 5), (100, 37), (257, 64),
                                             (7, 7), (517, 259), (1033, 517)])
def test_align_uniform_device_exact(mel_len, n_units):
    host = get_align_uniform(mel_len, n_units)
    got = align_uniform_device(mel_len, n_units).numpy()
    np.testing.assert_array_equal(got, host)
    np.testing.assert_array_equal(got, tfeat.get_align_uniform(mel_len,
                                                               n_units))


@pytest.mark.parametrize("f0", [
    [0, 220, 0, 0, 440, 0, 330, 0], [0, 0, 0, 0, 0, 0],
    [300, 0, 0, 0, 0, 310], [150, 160, 170]],
    ids=["gaps", "unvoiced", "ends", "voiced"])
def test_norm_interp_f0_device(f0):
    """Against the host version and JAX's device version (atol 1e-6); an
    all-unvoiced row gives zeros."""
    f0 = np.asarray(f0, np.float32)
    got, uv = norm_interp_f0_device(torch.from_numpy(f0))
    h_f0, h_uv = norm_interp_f0_np(f0)
    j_f0, j_uv = j_interp(jnp.asarray(f0))
    np.testing.assert_array_equal(uv.numpy(), h_uv)
    np.testing.assert_array_equal(uv.numpy(), np.asarray(j_uv))
    np.testing.assert_allclose(got.numpy(), h_f0, atol=1e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_f0), atol=1e-6)
    if not f0.any():
        assert (got.numpy() == 0).all()
    rows, _ = norm_interp_f0_device(torch.from_numpy(np.stack([f0, f0[::-1]])))
    np.testing.assert_array_equal(rows[0].numpy(), got.numpy())


# ---------------------------------------------------------------------------
# FusedSvc against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_fused")
    cfg_fn, ckpt = write_project(str(root / "proj"))
    hub_fn = str(root / "hubert_soft.pt")
    write_hubert(hub_fn, HubertConfig(**HUB), seed=2)
    return root, cfg_fn, ckpt, hub_fn


@pytest.fixture(scope="module")
def sides(project):
    """(torch Svc, torch HuBERT, JAX Svc, JAX HuBERT params, config)."""
    root, cfg_fn, ckpt, hub_fn = project
    cwd = os.getcwd()
    os.chdir(root)         # the Svcs keep ./infer_tools caches
    try:
        tsvc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
        jsvc = JSvc("proj", cfg_fn, False, ckpt)
    finally:
        os.chdir(cwd)
    thub = hubert_encoder.load(hub_fn, cfg=HubertConfig(**HUB))
    jcfg = jhubert.HubertConfig(**HUB)
    return tsvc, thub, jsvc, jhubert.load(hub_fn, jcfg), jcfg


def _jax_draws(rng, pad_t, n_voc, mel_bins=16, harmonics=9):
    """JAX's draws inside its fused program: the sampler's start noise from
    split(rng)[0] (models/diffusion.py:536-542) and the NSF source from
    fold_in(rng, 7) (generator.sine_gen_ht)."""
    noise = jax.random.normal(jax.random.split(rng)[0], (1, pad_t, mel_bins))
    k1, k2 = jax.random.split(jax.random.fold_in(rng, 7))
    return (np.asarray(noise),
            (np.asarray(jax.random.uniform(k1, (1, harmonics), jnp.float32)),
             np.asarray(jax.random.normal(k2, (1, harmonics, n_voc),
                                          jnp.float32))))


def _pair(sides, hp_over=None, **kw):
    tsvc, thub, jsvc, jhp, jcfg = sides
    hp_j = type(jsvc.hp)(jsvc.hp, **(hp_over or {}))
    hp_t = type(tsvc.hp)(tsvc.hp, **(hp_over or {}))
    jf = JFusedSvc(hp_j, jsvc.params, jsvc.vocoder, hubert_params=jhp,
                   hubert_cfg=jcfg, speedup=ACC, **kw)
    tf = FusedSvc(hp_t, tsvc.model, tsvc.vocoder, thub, speedup=ACC, **kw)
    return jf, tf


def _both(jf, tf, wav, seed=0, **kw):
    rng = jax.random.PRNGKey(seed)
    g = tf.geometry(tf._padded_length(len(wav)))
    noise, randoms = _jax_draws(rng, g["pad_t"], g["n_voc"])
    ref = [np.asarray(a) for a in jf(wav, rng, **kw)]
    got = tf(wav, init_noise=noise, voc_randoms=randoms, **kw)
    return got, ref


@pytest.mark.parametrize("case", ["f32", "bf16", "gt_mel", "dpmpp"])
def test_fused_matches_jax(sides, case):
    """f32 (PLMS, and the shallow-diffusion mode ``use_gt_mel``, and
    DPM-Solver++): waveform within 2e-3, f0 and mel alike; bf16 (the
    denoiser and HuBERT in bf16): the waveforms' correlation above 0.99."""
    hp_over, kw = {}, {}
    if case == "bf16":
        hp_over = dict(diff_compute_dtype="bfloat16",
                       hubert_compute_dtype="bfloat16")
    elif case == "gt_mel":
        kw = dict(use_gt_mel=True, add_noise_step=30)
    elif case == "dpmpp":
        hp_over = dict(sampler="dpmpp")
    jf, tf = _pair(sides, hp_over)
    wav = voiced_wav(secs=0.9, f0=220.0, gaps=[(0.5, 0.6)])
    (w, f0, mel), (rw, rf0, rmel) = _both(jf, tf, wav, key_shift=2, **kw)
    # unbucketed: the vocoder renders t_mel * hop <= len(wav) samples
    assert w.shape == rw.shape == (tf.geometry(len(wav))["n_voc"],)
    assert np.isfinite(w).all()
    assert np.abs(rw).max() > 1e-2
    assert f0.shape == rf0.shape and mel.shape == rmel.shape
    np.testing.assert_array_equal(f0 > 0, rf0 > 0)
    v = rf0 > 0
    assert np.median(rf0[v]) == pytest.approx(220.0 * 2 ** (2 / 12), rel=0.05)
    if case == "bf16":
        assert np.corrcoef(w, rw)[0, 1] > 0.99
    else:
        np.testing.assert_allclose(f0, rf0, rtol=1e-4)
        np.testing.assert_allclose(mel, rmel, atol=2e-3)
        np.testing.assert_allclose(w, rw, atol=2e-3)


def test_fused_batched_matches_sequential(sides):
    """``batched`` (one program at B = 2, per-chunk key shifts) against B = 1
    calls on the same padding and noise: atol 2e-4, as
    tests/test_fused.py holds JAX's."""
    _, tf = _pair(sides)
    w1 = voiced_wav(secs=1.0, f0=220.0)
    w2 = voiced_wav(secs=0.7, f0=330.0, seed=1)
    g = tf.geometry(len(w1))
    gen = torch.Generator().manual_seed(5)
    noise = torch.randn(2, g["pad_t"], 16, generator=gen)
    randoms = draw_randoms(2, g["n_voc"], 8, gen)
    outs = tf.batched([w1, w2], key_shifts=[0, 2], init_noise=noise,
                      voc_randoms=randoms)
    for i, (w, ks) in enumerate([(w1, 0), (w2, 2)]):
        wp = np.zeros(len(w1), np.float32)
        wp[: len(w)] = w
        ref = tf(wp, key_shift=ks, init_noise=noise[i: i + 1],
                 voc_randoms=tuple(r[i: i + 1] for r in randoms))
        t_true = -(-len(w) // HOP)
        bw, bf0, bm = outs[i]
        assert len(bw) == len(w) and len(bf0) == len(bm) == t_true
        np.testing.assert_allclose(bw, ref[0][: len(w)], atol=2e-4)
        np.testing.assert_allclose(bf0, ref[1][:t_true], atol=1e-3)
        np.testing.assert_allclose(bm, ref[2][:t_true], atol=2e-4)


def test_fused_int16_wires(sides):
    """``fused_input_int16``: a float input on the int16 grid gives exactly
    the float program's output, and an int16 array the flag's;
    ``fused_output_int16`` returns the rounded int16 of the float output.
    A mixed batch stays float."""
    _, tf = _pair(sides)
    wav_i16 = FusedSvc.to_int16(voiced_wav(secs=0.6, f0=200.0))
    wav = FusedSvc.to_float(wav_i16)
    kw = dict(generator=None)
    ref = tf(wav, **kw)
    _, t_in = _pair(sides, dict(fused_input_int16=True))
    for a, b, c in zip(t_in(wav, **kw), t_in(wav_i16, **kw), ref):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
    _, t_out = _pair(sides, dict(fused_output_int16=True))
    w16 = t_out(wav, **kw)[0]
    assert w16.dtype == np.int16
    np.testing.assert_array_equal(w16, FusedSvc.to_int16(ref[0]))
    assert set(k[-1] for k in t_in._fns) == {torch.int16}
    tf.batched([wav_i16, wav[:1000]])
    assert list(tf._fns)[-1][-1] == torch.float32


def test_fused_bucket_trims_and_captures_once(sides):
    """With ``fused_bucket_samples`` two lengths in one bucket share one
    program; outputs are trimmed to each input's length, and equal the
    unbucketed program on the zero-padded input."""
    _, tf = _pair(sides, dict(fused_bucket_samples=HOP * 32))
    _, plain = _pair(sides)
    wav = voiced_wav(secs=0.6, f0=250.0)
    for n in (len(wav), len(wav) - 301):
        w, f0, mel = tf(wav[:n])
        t_true = -(-n // HOP)
        assert len(w) == n and len(f0) == len(mel) == t_true
        padded = np.zeros(tf._padded_length(n), np.float32)
        padded[:n] = wav[:n]
        rw, rf0, _ = plain(padded)
        np.testing.assert_array_equal(w, rw[:n])
        np.testing.assert_array_equal(f0, rf0[:t_true])
    assert len(tf._fns) == 1


def test_fused_hp_snapshot_and_serving_flags(sides):
    """The hp is snapshotted at construction: a later change of the
    caller's dict does not reach a built FusedSvc.  ``voc_compute_dtype``
    bfloat16 changes nothing (K3 is f32, as JAX's fused program with its
    tail), and ``use_crepe`` changes nothing (the program's tracker is
    AC, as JAX's)."""
    tsvc = sides[0]
    hp = type(tsvc.hp)(tsvc.hp)
    tf = FusedSvc(hp, tsvc.model, tsvc.vocoder, sides[1], speedup=ACC)
    wav = voiced_wav(secs=0.5, f0=200.0)
    ref = tf(wav)
    hp["diff_compute_dtype"] = "bfloat16"
    hp["fused_output_int16"] = True
    assert tf.hp["diff_compute_dtype"] == "" and not tf.hp.get(
        "fused_output_int16")
    tf._fns.clear()
    for a, b in zip(tf(wav), ref):
        np.testing.assert_array_equal(a, b)
    for over in (dict(voc_compute_dtype="bfloat16"), dict(use_crepe=True)):
        _, other = _pair(sides, over)
        for a, b in zip(other(wav), ref):
            np.testing.assert_array_equal(a, b)


def test_fused_key_shift_doubles_f0(sides):
    _, tf = _pair(sides)
    wav = voiced_wav(secs=0.8, f0=220.0)
    _, f0, _ = tf(wav, key_shift=12)
    assert abs(np.median(f0[f0 > 0]) - 440.0) < 10


# ---------------------------------------------------------------------------
# the tracker runs on the caller's device
# ---------------------------------------------------------------------------

def test_tracker_runs_on_the_callers_device(project, monkeypatch, tmp_path):
    """``get_pitch`` hands ``track`` the caller's device, and ``Svc`` and
    the binarizer's ``process_item`` pass theirs to ``get_pitch``."""
    seen = []
    real = tf0.track

    def spy(wav, **kw):
        seen.append(wav.device)
        if wav.device.type == "meta":     # holds no data: an unvoiced track
            return torch.zeros(tf0.frame_grid(wav.shape[-1], SR, HOP,
                                              40.0)["n_frames"])
        return real(wav, **kw)

    monkeypatch.setattr(tf0, "track", spy)
    wav = voiced_wav(secs=0.5)
    meta = torch.device("meta")
    tfeat.get_pitch(wav, np.zeros((1 + len(wav) // HOP, 16)),
                    dict(TINY_HP), device=meta)
    assert seen == [meta]

    got = []
    real_gp = tfeat.get_pitch

    def gp_spy(*a, device=None, **kw):
        got.append(device)
        return real_gp(*a, device=device, **kw)

    monkeypatch.setattr(tfeat, "get_pitch", gp_spy)
    root, cfg_fn, ckpt, _ = project
    monkeypatch.chdir(root)
    svc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
    svc.hubert.encode = fake_units
    svc.infer(io.BytesIO(_wav_bytes(wav)), key=0, acc=ACC, use_pe=False)
    assert got == [svc.device]
    hp = dict(TINY_HP, vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN")
    item = tfeat.process_item("x", wav, hp,
                              lambda w: np.zeros((5, HID), np.float32),
                              device=torch.device("cpu"))
    assert item is not None and got[-1] == torch.device("cpu")



def _wav_bytes(wav):
    buf = io.BytesIO()
    wavfile.write(buf, SR, wav)
    return buf.getvalue()
