"""The port's serving routes on the CPU at tiny widths: ``Svc.infer_batched``
against the JAX package's (the same units and noise on both sides),
``run_clip`` through the fused, batched and crossfaded routes, the CLI
flags, the HTTP server (``diffsvc_tpu_torch.flask_api``, mirroring
tests/test_flask_api.py) and the folder batch entry point."""

import io
import os
import threading
import time
import urllib.error
import urllib.request
from http.server import HTTPServer

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from scipy.io import wavfile

from _torch_fixtures import (HID, HOP, SR, TINY_HP, TINY_VOC, fake_units,
                             voiced_wav)
from diffsvc_tpu.infer.svc import Svc as JSvc
from diffsvc_tpu_torch import batch as tbatch
from diffsvc_tpu_torch import flask_api, infer_cli
from diffsvc_tpu_torch.infer import hubert_encoder
from diffsvc_tpu_torch.infer.fused import FusedSvc
from diffsvc_tpu_torch.infer.svc import Svc as TSvc
from diffsvc_tpu_torch.models.hubert import HubertConfig
from diffsvc_tpu_torch.utils import synth
from diffsvc_tpu_torch.utils.audio_io import load_wav, save_wav

TINY_HUB = HubertConfig(dim=32, num_heads=2, num_layers=2, ffn_dim=64,
                        proj_dim=HID)
ACC = 10


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    """A tiny project whose HuBERT-soft .pt is at TINY_HUB's size."""
    root = tmp_path_factory.mktemp("torch_serving")
    config = dict(TINY_HP, vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN")
    cfg_fn, ckpt = synth.write_project(str(root / "proj"), config, TINY_VOC,
                                       hubert_cfg=TINY_HUB)
    return root, cfg_fn, ckpt


@pytest.fixture
def svc(project, monkeypatch):
    """The port's Svc on the CPU, its HuBERT at TINY_HUB's size."""
    root, cfg_fn, ckpt = project
    monkeypatch.chdir(root)
    monkeypatch.setenv("DIFFSVC_NO_COMPILE_CACHE", "1")
    real = hubert_encoder.load
    monkeypatch.setattr(hubert_encoder, "load",
                        lambda path, device="cpu", cfg=None: real(
                            path, device, TINY_HUB))
    return TSvc("proj", cfg_fn, False, ckpt, device="cpu")


def _wav_file(path, wav, sr=SR):
    save_wav(wav, str(path), sr)
    return str(path)


def test_infer_batched_matches_jax(svc, project, tmp_path, monkeypatch):
    """Two clips of one padded length: one sampling call and one vocoder
    call at B = 2 on each side, JAX's draws (its key's sampler noise and
    NSF source) passed to the port.  Waveforms within 2e-3, f0 alike."""
    from diffsvc_tpu.models import hubert as jhubert

    root, cfg_fn, ckpt = project
    # both sides take the units from fake_units: no HuBERT load on JAX's
    monkeypatch.setattr(jhubert, "load", lambda *a, **k: None)
    jsvc = JSvc("proj", cfg_fn, False, ckpt)
    svc.hubert.encode = fake_units
    jsvc.hubert.encode = fake_units
    clips = [_wav_file(tmp_path / "a.wav", voiced_wav(secs=1.0, f0=200.0)),
             _wav_file(tmp_path / "b.wav", voiced_wav(secs=0.85, f0=260.0,
                                                      seed=1))]
    seed, key = 4, 1
    ref = jsvc.infer_batched(clips, key=key, acc=ACC, use_pe=False,
                             use_crepe=False, seed=seed)
    t_mel = jsvc.pre(clips[0], ACC, use_crepe=False)["mels"].shape[1]
    rng = jax.random.PRNGKey(seed)
    noise = np.asarray(jax.random.normal(jax.random.split(rng)[0],
                                         (2, t_mel, 16)))
    k1, k2 = jax.random.split(rng)
    h = svc.vocoder.cfg.harmonic_num + 1
    rand_ini = np.asarray(jax.random.uniform(k1, (2, h), jnp.float32))
    unit = np.asarray(jax.random.normal(k2, (2, h, t_mel * HOP), jnp.float32))
    got = svc.infer_batched(clips, key=key, acc=ACC, use_pe=False,
                            init_noise=list(noise),
                            voc_randoms=[(rand_ini[i], unit[i])
                                         for i in range(2)])
    for (f0_gt, f0_pred, wav), (rf0_gt, rf0_pred, rwav) in zip(got, ref):
        assert wav.shape == rwav.shape and np.abs(rwav).max() > 1e-2
        np.testing.assert_allclose(f0_gt, rf0_gt, rtol=1e-5)
        np.testing.assert_allclose(f0_pred, rf0_pred, rtol=1e-5)
        np.testing.assert_allclose(wav, rwav, atol=2e-3)


def test_infer_batched_floors_collate_padding(svc, tmp_path):
    """The shorter clip of a group is vocoded with its collate padding at
    mel_vmin: its kept audio equals a batch of its own (B = 1, the same
    noise) to the vocoder's receptive-field edge effects only (atol
    2e-3)."""
    svc.hubert.encode = fake_units
    a = _wav_file(tmp_path / "a.wav", voiced_wav(secs=1.0, f0=200.0))
    b = _wav_file(tmp_path / "b.wav", voiced_wav(secs=0.6, f0=260.0))
    t_mel = svc.pre(a, ACC)["mels"].shape[1]
    rs = np.random.RandomState(0)
    noise = [rs.randn(t_mel, 16).astype(np.float32) for _ in range(2)]
    vr = [(rs.rand(9).astype(np.float32),
           rs.randn(9, t_mel * HOP).astype(np.float32)) for _ in range(2)]
    both = svc.infer_batched([a, b], key=0, acc=ACC, use_pe=False,
                             init_noise=noise, voc_randoms=vr)
    alone = svc.infer_batched([b], key=0, acc=ACC, use_pe=False,
                              init_noise=noise[1:], voc_randoms=vr[1:])
    np.testing.assert_allclose(both[1][2], alone[0][2], atol=2e-3)


@pytest.mark.parametrize("route", [
    dict(fused=True), dict(batch_chunks=True), dict(crossfade_ms=30.0),
    dict(crossfade_ms=30.0, batch_chunks=True),
    dict(crossfade_ms=30.0, fused=True)],
    ids=["fused", "batch_chunks", "crossfade", "crossfade_batched",
         "crossfade_fused"])
def test_run_clip_routes_keep_length(svc, tmp_path, route):
    """run_clip through each serving route on a clip the slicer cuts: the
    output has the input's length, finite and non-silent."""
    svc.hubert.encode = fake_units
    wav = voiced_wav(secs=12.0, f0=180.0, gaps=[(5.5, 6.5)])
    src = _wav_file(tmp_path / "long.wav", wav)
    out_fn = str(tmp_path / "out.wav")
    _, f0_pred, audio = infer_cli.run_clip(
        svc, key=0, acc=ACC, use_pe=False, use_crepe=False, thre=0.05,
        use_gt_mel=False, add_noise_step=500, file_path=src,
        out_path=out_fn, **route)
    got, sr = load_wav(out_fn)
    assert sr == SR and len(got) == len(wav) == len(audio)
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
    assert (np.asarray(f0_pred) > 0).any()
    if route.get("fused"):
        assert svc.hp["fused_bucket_samples"] == HOP * 256


def test_crossfade_concat_matches_jax():
    """crossfade_concat against the repository's infer.py."""
    import infer as jinfer

    rs = np.random.RandomState(0)
    pieces = [(rs.randn(n).astype(np.float32), int(ol), int(orr))
              for n, ol, orr in [(500, 0, 40), (800, 40, 40), (300, 40, 0),
                                 (60, 0, 0), (200, 30, 0)]]
    for k in range(1, len(pieces) + 1):
        np.testing.assert_array_equal(infer_cli.crossfade_concat(pieces[:k]),
                                      jinfer.crossfade_concat(pieces[:k]))
    assert len(infer_cli.crossfade_concat([])) == 0


@pytest.mark.parametrize("flags", [["--fused"], ["--batch_chunks",
                                                 "--crossfade_ms", "25"]],
                         ids=["fused", "batched_crossfade"])
def test_infer_cli_main_serving_flags(svc, project, monkeypatch, tmp_path,
                                      flags):
    """``python -m diffsvc_tpu_torch.infer_cli`` with the serving flags
    (in process): output under ./results with the input's length."""
    _, cfg_fn, ckpt = project
    monkeypatch.setattr(hubert_encoder.Hubertencoder, "encode",
                        lambda self, w: fake_units(w))
    src = _wav_file(tmp_path / "song.wav",
                    voiced_wav(secs=6.0, f0=200.0, gaps=[(2.5, 3.2)]))
    infer_cli.main(["--project", "proj", "--model", ckpt, "--config", cfg_fn,
                    "--files", src, "--key", "2", "--acc", str(ACC),
                    "--device", "cpu", *flags])
    got, sr = load_wav("results/song_2key_proj_32_4_1k_10x.wav")
    assert sr == SR and len(got) == int(6.0 * SR)
    assert np.abs(got).max() > 1e-3


# ---------------------------------------------------------------------------
# the HTTP server
# ---------------------------------------------------------------------------

class FakeModel:
    """A stateless converter (0.5x) with the server's view of a model."""
    hp = {"audio_sample_rate": 8000, "hop_size": 64}

    def infer(self, input_wav, key, acc, use_pe, use_crepe):
        sr, data = wavfile.read(input_wav)
        self.last_dtype = data.dtype
        self.last_key = key
        self.last_data = data
        return np.zeros(10), np.zeros(10), data.astype(np.float32) / 32768.0 \
            * 0.5


def _multipart(fields, file_bytes):
    boundary = "testboundary123"
    body = b""
    for k, v in fields.items():
        body += (f"--{boundary}\r\nContent-Disposition: form-data; "
                 f'name="{k}"\r\n\r\n{v}\r\n').encode()
    body += (f"--{boundary}\r\nContent-Disposition: form-data; "
             f'name="sample"; filename="in.wav"\r\n'
             "Content-Type: audio/wav\r\n\r\n").encode()
    body += file_bytes + f"\r\n--{boundary}--\r\n".encode()
    return body, f"multipart/form-data; boundary={boundary}"


def _pcm16(x, sr=SR):
    buf = io.BytesIO()
    wavfile.write(buf, sr, (x * 32767).astype(np.int16))
    return buf.getvalue()


def _post(port, body, ctype):
    """(status, response wav as float32 or None)."""
    req = urllib.request.Request(
        f"http://127.0.0.1:{port}/voiceChangeModel", data=body,
        headers={"Content-Type": ctype}, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as resp:
            sr, out = wavfile.read(io.BytesIO(resp.read()))
            return resp.status, sr, out.astype(np.float32) / 32767.0
    except urllib.error.HTTPError as e:
        return e.code, None, None


class _Server:
    def __init__(self, handler):
        self.server = HTTPServer(("127.0.0.1", 0), handler)
        self.port = self.server.server_address[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)

    def __enter__(self):
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=10)
        assert not self.thread.is_alive()

    def post(self, wav_bytes, pitch="0", rate=str(SR)):
        body, ctype = _multipart({"fPitchChange": pitch, "sampleRate": rate},
                                 wav_bytes)
        return _post(self.port, body, ctype)


@pytest.mark.parametrize("fused", [False, True], ids=["modular", "fused"])
def test_server_converts_through_the_port(svc, fused):
    """The port's Svc behind the server: 200 at the DAW's rate, through
    the modular and the fused route; the fused route keeps the posted
    duration exactly, the modular one answers the vocoder's whole frames
    (within a hop), as the JAX package's server does."""
    svc.hubert.encode = fake_units
    wav = voiced_wav(secs=0.7, f0=220.0)
    with _Server(flask_api.make_handler(svc, ACC, fused=fused)) as srv:
        for rate in (SR, 16000):
            status, sr, out = srv.post(_pcm16(wav), pitch="2", rate=str(rate))
            assert status == 200 and sr == rate
            want = len(wav) * rate // SR
            if fused:
                assert len(out) == want
            else:
                assert 0 <= want - len(out) <= HOP * rate // SR
            assert np.abs(out).max() > 1e-3
    if fused:
        assert svc.hp["fused_input_int16"] and svc.hp["fused_output_int16"]


def test_streaming_keeps_buffer_duration_and_continuity():
    model = FakeModel()
    stream = flask_api.make_stream(model, acc=50, fused=False,
                                   context_ms=100.0, crossfade_ms=40.0)
    n = 1600
    x = (0.4 * np.sin(2 * np.pi * 220 * np.arange(3 * n) / SR)
         ).astype(np.float32)
    with _Server(flask_api.make_handler(model, 50, stream=stream)) as srv:
        got = []
        for k in range(3):
            status, sr, out = srv.post(_pcm16(x[k * n:(k + 1) * n]))
            assert status == 200 and sr == SR and len(out) == n
            got.append(out)
    y = np.concatenate(got)
    c = stream.C
    assert np.all(got[0][:c] == 0)
    np.testing.assert_allclose(y[c:], 0.5 * x[: 3 * n - c], atol=2e-4)


def test_streaming_sub_crossfade_buffers_are_gapless():
    model = FakeModel()
    stream = flask_api.make_stream(model, acc=50, fused=False,
                                   context_ms=100.0, crossfade_ms=40.0)
    n, k_bufs = 100, 20
    x = (0.4 * np.cos(2 * np.pi * 220 * np.arange(k_bufs * n) / SR)
         ).astype(np.float32)
    with _Server(flask_api.make_handler(model, 50, stream=stream)) as srv:
        got = []
        for k in range(k_bufs):
            status, _, out = srv.post(_pcm16(x[k * n:(k + 1) * n]))
            assert status == 200 and len(out) == n
            got.append(out)
    y = np.concatenate(got)
    d = np.nonzero(y)[0][0]
    assert d <= 2 * stream.C + n
    np.testing.assert_allclose(y[d:], 0.5 * x[: len(y) - d], atol=2e-4)


def test_streaming_idle_reset_restarts_the_stream():
    model = FakeModel()
    stream = flask_api.make_stream(model, acc=50, fused=False,
                                   context_ms=100.0, crossfade_ms=40.0,
                                   idle_reset_s=0.05)
    n, c = 1600, stream.C
    with _Server(flask_api.make_handler(model, 50, stream=stream)) as srv:
        got = []
        for k in range(2):
            x = (0.4 * np.sin(2 * np.pi * (220 + 40 * k) * np.arange(n) / SR)
                 ).astype(np.float32)
            _, _, out = srv.post(_pcm16(x))
            got.append((x, out))
            time.sleep(0.15)
    for x, out in got:
        assert len(out) == n and np.all(out[:c] == 0)
        np.testing.assert_allclose(out[c:], 0.5 * x[: n - c], atol=2e-4)


def test_malformed_uploads_are_400_and_the_server_keeps_serving():
    model = FakeModel()
    good = _pcm16(0.1 * np.sin(2 * np.pi * 220 * np.arange(SR) / SR))
    with _Server(flask_api.make_handler(model, 50)) as srv:
        assert _post(srv.port, b"x", "application/json")[0] == 400
        assert srv.post(good[:40])[0] == 400
        for pitch in ("not-a-number", "4800", "nan", "inf"):
            assert srv.post(good, pitch=pitch)[0] == 400, pitch
        assert srv.post(good, rate="0")[0] == 400
        boundary = "testboundary123"
        body = (f"--{boundary}\r\nContent-Disposition: form-data; "
                f'name="fPitchChange"\r\n\r\n0\r\n--{boundary}--\r\n').encode()
        assert _post(srv.port, body,
                     f"multipart/form-data; boundary={boundary}")[0] == 400
        status, _, _ = srv.post(good, pitch="1")
        assert status == 200 and model.last_key == 1.0


def test_server_side_failures_are_500():
    class BrokenModel:
        hp = {"audio_sample_rate": 8000, "hop_size": 64}

        def infer(self, input_wav, key, acc, use_pe, use_crepe):
            raise KeyError("residual_channels")

    good = _pcm16(0.1 * np.sin(2 * np.pi * 220 * np.arange(SR) / SR))
    with _Server(flask_api.make_handler(BrokenModel(), 50)) as srv:
        assert srv.post(good)[0] == 500


def test_float_uploads_are_quantized_as_jax_does():
    """A float32 upload reaches the modular route quantized to int16 the
    way the JAX package's server does it (clip, x 32767, truncate), so a
    request gives the same audio in both."""
    model = FakeModel()
    x = (0.3 * np.sin(2 * np.pi * 220 * np.arange(SR) / SR)
         + 1e-6).astype(np.float32)
    buf = io.BytesIO()
    wavfile.write(buf, SR, x)
    with _Server(flask_api.make_handler(model, 50)) as srv:
        assert srv.post(buf.getvalue())[0] == 200
    assert model.last_dtype == np.int16
    np.testing.assert_array_equal(
        model.last_data, (np.clip(x, -1, 1) * 32767).astype(np.int16))


def test_warmup_fused_builds_every_bucket(svc):
    """``warmup_fused`` runs one silent buffer per bucket up to the given
    duration, each padded up to its own bucket: one program per bucket."""
    n = flask_api.warmup_fused(svc, acc=ACC, max_seconds=2.5)
    bucket = svc.hp["fused_bucket_samples"]
    assert n == -(-int(2.5 * SR) // bucket) == 2
    fused = svc.fused_model(ACC)
    assert sorted(k[0] for k in fused._fns) == [bucket, 2 * bucket]
    assert fused.hp["fused_input_int16"] and fused.hp["fused_output_int16"]
    assert fused.pool_bytes() == {}      # eager on the CPU: no graphs


def test_fused_output_decodes_through_the_int16_wire(svc):
    """infer_fused with both int16 wires gives the float program's output
    rounded to int16."""
    wav = FusedSvc.to_float(FusedSvc.to_int16(voiced_wav(secs=0.5)))
    ref, _, _ = svc.infer_fused(wav, key=0, acc=ACC)
    svc.hp["fused_output_int16"] = svc.hp["fused_input_int16"] = True
    got, _, _ = svc.infer_fused(wav, key=0, acc=ACC)
    assert got.dtype == np.float32     # the built FusedSvc keeps its snapshot
    svc._fused = None
    got, _, _ = svc.infer_fused(wav, key=0, acc=ACC)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, FusedSvc.to_int16(ref))


# ---------------------------------------------------------------------------
# the folder batch entry point
# ---------------------------------------------------------------------------

def test_batch_main_writes_singer_data(svc, project, monkeypatch):
    """``python -m diffsvc_tpu_torch.batch`` (in process): every wav under
    ./batch converted, with its mel and f0 beside it."""
    _, cfg_fn, ckpt = project
    monkeypatch.setattr(hubert_encoder.Hubertencoder, "encode",
                        lambda self, w: fake_units(w))
    os.makedirs("batch", exist_ok=True)
    wav = voiced_wav(secs=0.8, f0=240.0)
    save_wav(wav, "batch/take1.wav", SR)
    tbatch.main(["--project", "proj", "--model", ckpt, "--config", cfg_fn,
                 "--acc", str(ACC), "--device", "cpu"])
    got, sr = load_wav("singer_data/take1.wav")
    assert sr == SR and len(got) > 0 and np.isfinite(got).all()
    mel = np.load("singer_data/take1_mel.npy")
    f0 = np.load("singer_data/take1_f0.npy")
    assert mel.shape[1] == 16 and len(f0) == len(mel)
