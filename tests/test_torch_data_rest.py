"""The port's data inventory against the JAX package, on the CPU: the
batched binarization pipeline (``features.process_items_batched`` and the
binarizer's batched branch), the f0 track cache and the TextGrid
alignment of ``process_item``.

The fixture follows ``tests/test_batched_binarize.py`` (8 kHz, 16 mel
bins, ``wav_bucket_frames`` 32).  The content encoder is a numpy stand-in
shared by both packages whose units are the 16 kHz waveform itself, cut
into 320-sample frames, so the resample feeding ``encode_batch`` is held
too.
"""

import os

import numpy as np
import pytest

from diffsvc_tpu.config import HParams as JHParams
from diffsvc_tpu.data import binarizer as jbin
from diffsvc_tpu.data import features as jfeat
from diffsvc_tpu.data.indexed_datasets import IndexedDataset
from diffsvc_tpu.utils.audio_io import save_wav
from diffsvc_tpu_torch.config import HParams
from diffsvc_tpu_torch.data import binarizer as tbin
from diffsvc_tpu_torch.data import features as tfeat
from diffsvc_tpu_torch.ops import f0_ac as tf0
from diffsvc_tpu_torch.utils.audio_io import load_wav

SR = 8000
NSF = "diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN"


def _hp(tmp, vocoder="HifiGAN", **kw):
    return dict(
        audio_sample_rate=SR, audio_num_mel_bins=16, fft_size=256,
        hop_size=64, win_size=256, fmin=30, fmax=4000, wav2spec_eps=1e-6,
        vocoder=vocoder, use_crepe=False, f0_bin=256, f0_min=50.0,
        f0_max=1100.0, pitch_norm="log", use_uv=False, speaker_id="t",
        wav_bucket_frames=32,
        binarization_args=dict(with_f0=True, with_hubert=True,
                               with_align=True, with_wav=False,
                               shuffle=False),
        raw_data_dir=str(tmp / "raw"), num_spk=1, use_spk_id=False,
        choose_test_manually=False, test_prefixes=[],
        **{"f0_cache_dir": "", **kw})


def _units(wav16):
    """[B, L] -> [B, L // 320, 8]: each frame's first 8 samples, x10."""
    b, n = wav16.shape[0], wav16.shape[1] // 320
    return np.asarray(wav16[:, : n * 320], np.float32).reshape(
        b, n, 320)[:, :, :8] * 10.0


class Enc:
    """The numpy stand-in with weights (``params`` for the JAX binarizer's
    gate, ``model`` for the port's); counts its batched calls."""

    params = model = object()

    def __init__(self):
        self.batches = 0

    def encode(self, wav_fn):
        npy = os.path.splitext(wav_fn)[0] + ".npy"
        if os.path.exists(npy):        # as Hubertencoder.encode
            return np.load(npy)
        wav, _ = load_wav(wav_fn, sr=16000)
        return _units(np.asarray(wav)[None])[0]

    def encode_batch(self, wavs16):
        self.batches += 1
        return _units(wavs16)


@pytest.fixture()
def wav_dir(tmp_path):
    raw = tmp_path / "raw"
    raw.mkdir()
    for i in range(7):      # two length buckets: 5 clips, then 2
        t = np.arange(int(SR * (0.3 + 0.05 * i))) / SR
        wav = 0.4 * np.sin(2 * np.pi * (160 + 30 * i) * t).astype(np.float32)
        save_wav(wav, str(raw / f"w{i}.wav"), SR)
    # a sibling .npy wins over the encoder; an all-zero clip has no f0
    np.save(raw / "w3.npy", np.full((9, 8), 0.5, np.float32))
    save_wav(np.zeros(SR // 2, np.float32), str(raw / "w7.wav"), SR)
    return tmp_path


def _metas(wav_dir):
    metas = [(f"w{i}", str(wav_dir / "raw" / f"w{i}.wav")) for i in range(8)]
    return metas + [("missing", str(wav_dir / "raw" / "nope.wav"))]


def _check_item(got, want, mel_tol):
    assert got["len"] == want["len"] and got["item_name"] == want["item_name"]
    np.testing.assert_allclose(got["mel"], want["mel"], **mel_tol)
    np.testing.assert_allclose(got["f0"], want["f0"], rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(got["mel2ph"], want["mel2ph"])
    np.testing.assert_array_equal(got["pitch"], want["pitch"])
    np.testing.assert_allclose(got["hubert"], want["hubert"], rtol=1e-5,
                               atol=1e-6)


# the front ends' cross-package mel tolerances: NSF's log-mel 1e-4
# (tests/test_torch_frontend.py); the pwg log10-mel 2e-3 at these 8 kHz,
# 16-bin settings (as tests/test_torch_24k.py's fused mel; f32 FFTs in
# another order, read through log10 of the quiet bins)
CROSS = {NSF: dict(rtol=1e-4, atol=1e-4),
         "HifiGAN": dict(rtol=1e-4, atol=2e-3)}


@pytest.mark.parametrize("front_end", ["own", "jax"])
@pytest.mark.parametrize("vocoder", ["HifiGAN", NSF], ids=["pwg_mel", "nsf"])
def test_process_items_batched_matches_jax(wav_dir, vocoder, front_end,
                                           monkeypatch):
    """The port's batched pipeline against JAX's on the same clips (one
    unreadable, one silent, one with a sibling .npy) in groups of 3: the
    same items skipped; per item mel within the front end's tolerance
    (``CROSS``), f0 within 1e-4 Hz, mel2ph and coarse pitch equal, units
    within 1e-5.  The port yields in input order.  With ``front_end``
    "jax" both packages read their mels from JAX's ``wav2spec_for``, so
    what the batched pipeline itself adds (grouping, the batched track cut
    onto each mel grid, the units' trim, the order) is held with the mel
    at rtol 1e-5 / atol 1e-6, without the front ends' own gap."""
    hp = _hp(wav_dir, vocoder)
    mel_tol = CROSS[vocoder]
    if front_end == "jax":
        def jax_wav2spec(hp_, wav_fn, device="cpu"):
            wav, mel = jfeat.wav2spec_for(JHParams(dict(hp_)), wav_fn)
            return np.asarray(wav), np.asarray(mel)

        monkeypatch.setattr(tfeat, "wav2spec_for", jax_wav2spec)
        mel_tol = dict(rtol=1e-5, atol=1e-6)
    metas = _metas(wav_dir)
    want = dict(jfeat.process_items_batched(metas, JHParams(hp),
                                            Enc().encode_batch,
                                            group_size=3))
    got = list(tfeat.process_items_batched(metas, HParams(hp),
                                           Enc().encode_batch,
                                           group_size=3))
    assert [i for i, _ in got] == list(range(len(metas)))
    got = dict(got)
    assert [i for i in got if got[i] is None] == \
        [i for i in sorted(want) if want[i] is None] == [7, 8]
    for i, item in got.items():
        if item is not None:
            _check_item(item, want[i], mel_tol)
    np.testing.assert_array_equal(got[3]["hubert"], np.full((9, 8), 0.5))


def test_batched_matches_per_item(wav_dir):
    """The port's batched items against its per-item ones as JAX's own test
    holds its pair (tests/test_batched_binarize.py:74-78): mel rtol 1e-5 /
    atol 1e-6, f0 rtol 1e-4 / atol 1e-3, mel2ph and len equal, units of
    equal shape (their values differ by design: the padding they see)."""
    hp = HParams(_hp(wav_dir))
    enc = Enc()
    metas = _metas(wav_dir)[:7]
    batched = dict(tfeat.process_items_batched(metas, hp, enc.encode_batch,
                                               group_size=3))
    for i, (name, fn) in enumerate(metas):
        ref = tfeat.process_item(name, fn, hp, enc.encode)
        got = batched[i]
        np.testing.assert_allclose(got["mel"], ref["mel"], rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(got["f0"], ref["f0"], rtol=1e-4, atol=1e-3)
        assert got["hubert"].shape == ref["hubert"].shape
        np.testing.assert_array_equal(got["mel2ph"], ref["mel2ph"])
        assert got["len"] == ref["len"]


def _binarize(mod, hp, enc):
    b = mod.SVCBinarizer(hp)
    b._phone_encoder = lambda: enc
    b.process()


@pytest.mark.parametrize("batch_size", [3, 1])
def test_batched_binarizer_matches_jax(wav_dir, batch_size, capfd):
    """Both binarizers over the same raw tree with ``binarize_batch_size``
    3 (the batched branch, one encoder call per group on both sides) or 1
    (item by item), NSF-HiFiGAN's front end: every split item by item as
    in tests/test_torch_training.py::test_binarizer_matches_jax (mel within
    the front end's 1e-4), the same lengths and spec stats.  An encoder
    without weights takes the per-item branch and says so."""
    outs = {}
    for tag, mod, H in (("jax", jbin, JHParams), ("torch", tbin, HParams)):
        hp = H(_hp(wav_dir, NSF, binarize_batch_size=batch_size,
                   binary_data_dir=str(wav_dir / f"bin_{tag}"),
                   config_path=str(wav_dir / f"cfg_{tag}.yaml")))
        enc = Enc()
        _binarize(mod, hp, enc)
        assert (enc.batches > 0) == (batch_size > 1)
        outs[tag] = hp
    for prefix in ("train", "valid", "test"):
        a = IndexedDataset(f"{outs['torch']['binary_data_dir']}/{prefix}")
        b = IndexedDataset(f"{outs['jax']['binary_data_dir']}/{prefix}")
        assert len(a) == len(b) > 0
        for i in range(len(a)):
            _check_item(a[i], b[i], CROSS[NSF])
    np.testing.assert_allclose(outs["torch"]["spec_min"],
                               outs["jax"]["spec_min"], atol=1e-4)
    if batch_size > 1:
        enc = Enc()
        enc.model = None
        hp = HParams(_hp(wav_dir, NSF, binarize_batch_size=batch_size,
                         binary_data_dir=str(wav_dir / "bin_noweights"),
                         config_path=str(wav_dir / "cfg_n.yaml")))
        capfd.readouterr()
        _binarize(tbin, hp, enc)
        assert enc.batches == 0
        assert "items go one by one" in capfd.readouterr().out


def _wav_mel(hp_dict, wav_dir, i=0):
    hp = HParams(hp_dict)
    wav, mel = tfeat.wav2spec_for(hp, str(wav_dir / "raw" / f"w{i}.wav"))
    return hp, wav, mel


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_f0_cache_is_shared_with_jax(wav_dir, monkeypatch, writer):
    """A track cached by one package is a hit for the other: the same file
    name (md5 of the float32 wav that ``wav2spec_for`` returns, the tag,
    the mel length), the reader's tracker never runs, the same f0 and
    coarse pitch."""
    hd = _hp(wav_dir, NSF, f0_cache_dir=str(wav_dir / "f0cache"))
    hp, wav, mel = _wav_mel(hd, wav_dir)
    jwav, jmel = jfeat.wav2spec_for(JHParams(hd),
                                    str(wav_dir / "raw" / "w0.wav"))
    assert wav.dtype == jwav.dtype == np.float32 and np.array_equal(wav, jwav)
    calls = {"jax": lambda: jfeat.get_pitch(jwav, jmel, JHParams(hd)),
             "torch": lambda: tfeat.get_pitch(wav, mel, hp)}
    reader = "torch" if writer == "jax" else "jax"
    f0_w, coarse_w = calls[writer]()
    files = os.listdir(hd["f0_cache_dir"])
    assert files == [os.path.basename(tfeat.f0_cache_path(
        hd["f0_cache_dir"], wav, len(mel), "ac"))]

    def no_track(*a, **k):
        raise AssertionError("tracked despite a cache hit")

    monkeypatch.setattr(tfeat, "get_pitch_ac", no_track)
    monkeypatch.setattr(jfeat, "get_pitch_ac", no_track)
    f0_r, coarse_r = calls[reader]()
    np.testing.assert_array_equal(f0_r, f0_w)
    np.testing.assert_array_equal(coarse_r, coarse_w)
    assert os.listdir(hd["f0_cache_dir"]) == files


def test_f0_cache_keeps_a_crepe_fallback_as_ac(wav_dir, monkeypatch):
    """CREPE asked for without its weights falls back to the AC tracker and
    caches the track as ``ac`` (not ``crepe``); an AC request then hits it,
    in the port and in JAX."""
    hd = _hp(wav_dir, NSF, f0_cache_dir=str(wav_dir / "f0cache"),
             crepe_path=str(wav_dir / "no_crepe" / "full.pth"))
    hp, wav, mel = _wav_mel(hd, wav_dir)
    f0, _, tag = tfeat.get_pitch(wav, mel, hp, use_crepe=True,
                                 return_tag=True)
    assert tag == "ac"
    (name,) = os.listdir(hd["f0_cache_dir"])
    assert "_ac_" in name and "crepe" not in name
    monkeypatch.setattr(tfeat, "get_pitch_ac", None)
    monkeypatch.setattr(jfeat, "get_pitch_ac", None)
    np.testing.assert_array_equal(tfeat.get_pitch(wav, mel, hp)[0], f0)
    np.testing.assert_array_equal(jfeat.get_pitch(wav, mel, JHParams(hd))[0],
                                  f0)


def _textgrid(intervals):
    xmax = intervals[-1][1]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0.0", f"xmax = {xmax}", "tiers? <exists>", "size = 1",
             "item []:", "    item [1]:", '        class = "IntervalTier"',
             '        name = "phones"', "        xmin = 0.0",
             f"        xmax = {xmax}",
             f"        intervals: size = {len(intervals)}"]
    for i, (a, b, t) in enumerate(intervals):
        lines += [f"        intervals [{i + 1}]", f"            xmin = {a}",
                  f"            xmax = {b}", f'            text = "{t}"']
    return "\n".join(lines)


@pytest.mark.parametrize("ph", ["<sil> AA B <sil>", None],
                         ids=["textgrid", "uniform"])
def test_process_item_textgrid_matches_jax(wav_dir, ph):
    """``process_item(tg_fn=, ph=)``: the forced-alignment mel2ph and dur
    equal JAX's (and the uniform alignment without ``ph``)."""
    secs = 0.3 + 0.05 * 2
    tg_fn = wav_dir / "w2.TextGrid"
    tg_fn.write_text(_textgrid([(0.0, 0.08, "sil"), (0.08, 0.2, "AA"),
                                (0.2, 0.33, "B"), (0.33, secs, "sp")]))
    hd = _hp(wav_dir)
    args = ("w2", str(wav_dir / "raw" / "w2.wav"))
    enc = Enc()
    got = tfeat.process_item(*args, HParams(hd), enc.encode,
                             tg_fn=str(tg_fn), ph=ph)
    want = jfeat.process_item(*args, JHParams(hd), enc.encode,
                              tg_fn=str(tg_fn), ph=ph)
    np.testing.assert_array_equal(got["mel2ph"], want["mel2ph"])
    assert ("dur" in got) == ("dur" in want) == (ph is not None)
    if ph is not None:
        np.testing.assert_array_equal(got["dur"], want["dur"])
        assert got["mel2ph"].max() == 4 and got["dur"].sum() > 0


def test_tracker_batch_equals_rows():
    """``f0_ac.track`` over a batch equals each row tracked alone (the
    batched binarizer's one track per group)."""
    import torch

    rng = np.random.RandomState(0)
    t = np.arange(SR) / SR
    wavs = np.stack([0.4 * np.sin(2 * np.pi * f * t) + 0.01 * rng.randn(SR)
                     for f in (150.0, 230.0, 310.0)]).astype(np.float32)
    kw = dict(sr=SR, hop=64, f0_min=50.0, f0_max=1100.0)
    batch = tf0.track(torch.from_numpy(wavs), **kw)
    for i, w in enumerate(wavs):
        torch.testing.assert_close(batch[i], tf0.track(torch.from_numpy(w),
                                                       **kw))
