"""The whole conversion slice: the torch port's ``Svc`` against the JAX
chain on the same reference-format checkpoint files, on the CPU.

Both sides get the same HuBERT units (a deterministic stand-in; HuBERT
itself is held against JAX in test_torch_frontend.py), the same sampler
start noise and the same NSF source draws.  The JAX facade draws its own
noise, so its side calls the functions ``Svc.infer`` calls, with the noise
passed in.  The port's process must stay free of JAX (checked in a
subprocess: this test process imports JAX through conftest.py).
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_fixtures import (HOP, SR, TINY_HP, TINY_VOC, fake_units,
                             voiced_wav, write_project)
from diffsvc_tpu.infer.svc import Svc as JSvc
from diffsvc_tpu.ops.mel import LN_10
from diffsvc_tpu.utils.audio_io import load_wav, save_wav
from diffsvc_tpu.vocoders import generator as jgen
from diffsvc_tpu_torch import infer_cli
from diffsvc_tpu_torch.infer.svc import Svc as TSvc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_slice")
    cfg_fn, ckpt = write_project(str(root / "proj"))
    wav_fn = str(root / "in.wav")
    save_wav(voiced_wav(secs=1.5, f0=200.0), wav_fn, SR)
    return root, cfg_fn, ckpt, wav_fn


@pytest.fixture
def in_root(project, monkeypatch):
    monkeypatch.chdir(project[0])          # Svc keeps ./infer_tools caches
    monkeypatch.setenv("DIFFSVC_NO_COMPILE_CACHE", "1")
    return project


def _jax_randoms(rng, length, harmonic_num):
    k1, k2 = jax.random.split(rng)
    h = harmonic_num + 1
    return (np.array(jax.random.uniform(k1, (1, h), dtype=jnp.float32)),
            np.array(jax.random.normal(k2, (1, h, length), jnp.float32)))


@pytest.mark.parametrize("dtype", ["", "bfloat16"], ids=["f32", "bf16"])
def test_svc_infer_matches_jax_chain(in_root, dtype):
    """f32: waveform within 2e-3 (sampler 2e-4 in the normalized mel, then
    the vocoder); bf16: the denoiser rounds at other points in each
    implementation, so the mel is compared with bf16-scaled bounds
    (mean 0.05) and the waveforms' correlation must exceed 0.99."""
    _, cfg_fn, ckpt, wav_fn = in_root
    tsvc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
    jsvc = JSvc("proj", cfg_fn, False, ckpt)
    tsvc.hp["diff_compute_dtype"] = jsvc.hp["diff_compute_dtype"] = dtype
    tsvc.hubert.encode = fake_units
    jsvc.hubert.encode = fake_units
    key, acc = 2, 10

    # --- JAX chain: Svc.infer's steps with the noise passed in
    batch = jsvc.pre(wav_fn, acc, use_crepe=False)
    batch["f0"] = batch["f0"] + key / 12
    batch["f0"][batch["f0"] > np.log2(jsvc.hp["f0_max"])] = 0
    jb = {k: jnp.asarray(batch[k]) for k in
          ("hubert", "mels", "mel2ph", "energy", "f0", "uv")}
    noise = np.random.RandomState(11).randn(
        *batch["mels"].shape).astype(np.float32)
    out = jsvc.model.infer(jsvc.params, jb, jax.random.PRNGKey(0),
                           speedup=acc, init_noise=jnp.asarray(noise))
    mel = np.asarray(out["mel_out"])[0]
    mask = np.abs(mel).sum(-1) > 0
    mel_pred = np.clip(mel[mask], jsvc.hp["mel_vmin"], jsvc.hp["mel_vmax"])
    f0_pred = np.asarray(out["f0_denorm"])[0][mask]
    voc = jsvc.vocoder
    randoms = _jax_randoms(jax.random.PRNGKey(5), len(mel_pred) * HOP,
                           voc.cfg.harmonic_num)
    f0_up = jgen.upsample_nearest(jnp.asarray(f0_pred)[None], HOP)
    har, _ = jgen.source_module_from_randoms(
        voc.params["m_source"], jnp.asarray(randoms[0]),
        jnp.asarray(randoms[1]), f0_up, voc.cfg.sampling_rate,
        voc.cfg.harmonic_num)
    ref_wav = np.asarray(jgen.apply_conv_stack(
        voc.params, voc.cfg, jnp.asarray(mel_pred)[None] * LN_10, har))[0]

    # --- the port's facade
    f0_gt, t_f0_pred, wav = tsvc.infer(
        wav_fn, key=key, acc=acc, use_pe=False, use_crepe=False,
        init_noise=noise, voc_randoms=tuple(torch.from_numpy(r)
                                            for r in randoms))
    assert wav.shape == ref_wav.shape and np.isfinite(wav).all()
    assert np.abs(ref_wav).max() > 1e-2
    np.testing.assert_allclose(t_f0_pred, f0_pred, rtol=1e-5)
    voiced = f0_gt[f0_gt > 0]
    assert abs(np.median(voiced) - 200.0 * 2 ** (key / 12)) < 10
    if not dtype:
        np.testing.assert_allclose(wav, ref_wav, atol=2e-3)
    else:
        assert np.corrcoef(wav, ref_wav)[0, 1] > 0.99


def test_run_clip_slices_and_keeps_length(in_root, tmp_path):
    """run_clip on a clip whose silences the slicer cuts: the output has the
    input's length and is finite and non-silent."""
    _, cfg_fn, ckpt, _ = in_root
    svc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
    svc.hubert.encode = fake_units
    wav = voiced_wav(secs=12.0, f0=180.0, gaps=[(5.5, 6.5)])
    src = str(tmp_path / "long.wav")
    save_wav(wav, src, SR)
    out_fn = str(tmp_path / "out.wav")
    _, f0_pred, audio = infer_cli.run_clip(
        svc, key=0, acc=10, use_pe=False, use_crepe=False, thre=0.05,
        use_gt_mel=False, add_noise_step=500, file_path=src, out_path=out_fn)
    got, sr = load_wav(out_fn)
    assert sr == SR and len(got) == len(wav) == len(audio)
    assert np.isfinite(got).all() and np.abs(got).max() > 1e-3
    chunks = json.load(open("infer_tools/new_chunks_temp.json"))
    n_chunks = [len(v["chunks"]) for v in chunks.values()
                if isinstance(v, dict) and "chunks" in v]
    assert max(n_chunks) >= 2


SCRIPT = r"""
import json, os, sys
sys.path.insert(0, {tests!r})
import numpy as np
import diffsvc_tpu_torch
import diffsvc_tpu_torch.binarize, diffsvc_tpu_torch.run
import diffsvc_tpu_torch.batch, diffsvc_tpu_torch.flask_api
from diffsvc_tpu_torch.infer import fused, streaming
from diffsvc_tpu_torch.data import batching, binarizer, dataset, indexed_datasets
from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train
from diffsvc_tpu_torch.ops import crepe
from diffsvc_tpu_torch.models import contentvec, pe
from diffsvc_tpu_torch.models import candidate_decoder, tts_modules
from diffsvc_tpu_torch.parallel import dist
from diffsvc_tpu_torch.vocoders import hifigan, vocoder_utils
from diffsvc_tpu_torch.vocoders import (discriminators, istft_head, melgan,
                                        pqmf, pwg, source)
from diffsvc_tpu_torch.ops import istft, loudness, stft_loss
from diffsvc_tpu_torch.training import checkpoint, scheduler, task, trainer
from diffsvc_tpu_torch.training import vocoder_task
from _torch_fixtures import SR, fake_units, voiced_wav, write_project
from diffsvc_tpu_torch.utils.audio_io import save_wav
from diffsvc_tpu_torch.infer.svc import Svc
cfg_fn, ckpt = write_project("proj")
save_wav(voiced_wav(secs=1.0), "in.wav", SR)
svc = Svc("proj", cfg_fn, False, ckpt, device="cpu")
svc.hubert.encode = fake_units
_, _, wav = svc.infer("in.wav", key=0, acc=10, use_pe=False, use_crepe=True)
_, _, wav1 = svc.infer("in.wav", key=0, acc=1, use_pe=False, use_crepe=False)
from diffsvc_tpu_torch.models.hubert import HubertConfig
from diffsvc_tpu_torch.utils.synth import write_hubert
hub = write_hubert("hub.pt", HubertConfig(dim=32, num_heads=2, num_layers=2,
                                          ffn_dim=64, proj_dim=32))
fwav, _, _ = fused.FusedSvc(svc.hp, svc.model, svc.vocoder, hub.eval(),
                            speedup=10)(np.zeros(4000, np.float32))
# the rest of training and the data inventory: a batched binarize (the
# tiny HuBERT's encode_batch) and --infer on a task checkpoint
from diffsvc_tpu_torch.data import textgrid
from diffsvc_tpu_torch.ops import cwt, ssim
from diffsvc_tpu_torch.training import losses, pe_task, test_runner
from diffsvc_tpu_torch.utils import misc, multiprocess, text_encoder, text_norm
from diffsvc_tpu_torch.config import HParams
from diffsvc_tpu_torch.run import run_task
os.makedirs("raw")
for i in range(7):
    save_wav(voiced_wav(secs=0.5 + 0.1 * i, seed=i), f"raw/c{{i}}.wav", SR)
hp = HParams(dict(svc.hp, raw_data_dir="raw", binary_data_dir="bin",
                  config_path="bin_cfg.yaml", work_dir="work", num_spk=1,
                  use_spk_id=False, choose_test_manually=False,
                  binarize_batch_size=4, max_tokens=4000, max_sentences=4,
                  max_eval_tokens=4000, frames_multiple=32, task_cls="SVCTask",
                  lr=1e-3, scheduler="step_lr", decay_steps=100))
enc = svc.hubert
enc.model = hub.eval()
n_batches = []
enc.encode_batch = (lambda f: lambda w: n_batches.append(1) or f(w))(
    enc.encode_batch)
b = binarizer.SVCBinarizer(hp, device="cpu")
b._phone_encoder = lambda: enc
b.process()
t = task.SVCTask(hp, device="cpu")
checkpoint.save_checkpoint("work", t.state_dict(), 0, 0)
run_task(HParams(dict(hp, infer=True)), device="cpu")
n_mels = len(os.listdir("work/P_mels_npy"))
# the ONNX export: its modules, the CLI, and the four graphs of the tiny
# project run through the port's runtime
import diffsvc_tpu_torch.onnx_export
from diffsvc_tpu_torch.onnx import (builder, chain, convert, runtime,
                                    svc_export, wire)
onnx_paths = svc_export.export_svc_onnx(svc.hp, svc.model, "onnx", "proj")
onnx_ok = bool(np.isfinite(runtime.OnnxRunner(open(
    onnx_paths["after"], "rb").read())(np.zeros((1, 1, svc.mel_bins, 5),
                                                np.float32))[0]).all())
# the compiled-program export: the op library (K1-K3 registered), the
# consumer and simplify CLIs, the tiny project's pt2 set written and its
# denoiser reloaded and run
import torch
import diffsvc_tpu_torch.run_exported, diffsvc_tpu_torch.simplify
import diffsvc_tpu_torch.ops.hopper as hopper
from diffsvc_tpu_torch.infer import export as pt2
pt2_paths = pt2.SvcExporter(svc.hp, svc.model, device="cpu").export(
    "pt2", t_mel=16, t_ph=8)
den = hopper.load_program(pt2_paths["denoiser"])
pt2_ok = all(hasattr(torch.ops.diffsvc_tpu_torch, op) for op in (
    "residual_stack", "plms_ladder", "vocoder_tail")) and bool(torch.isfinite(
    den(torch.zeros(1, 16, svc.mel_bins), torch.tensor([3]),
        torch.zeros(1, 16, svc.hp["hidden_size"]))).all())
# the learned-score tools and their data recipe
from diffsvc_tpu_torch.tools import sampler_quality, train_demo
from diffsvc_tpu_torch.utils.synth import make_dataset
make_dataset("learn_raw", sr=8000, n_clips=1, dur=0.2)
# the vocoder's learned-quality tools and the train-stream A/B, their data
from diffsvc_tpu_torch.tools import ab_train_stream, ab_vocoder, train_istft
train_istft.make_clips(8000, 1, 0.2, 64, 16, 256, 256, 40.0, 3500.0)
ab_train_stream.make_batch(dict(B=1, T=128, n_mel=16, H=256), 0)
# the one-command drive and the mel-MCD metric, the train step's repeat check
from diffsvc_tpu_torch.tools import compare_mel, step_repeat, verify_drive
verify_drive.write_songs("drive_raw")
mcd = compare_mel.mel_mcd(np.zeros((4, 16)), np.zeros((4, 16)))
forbidden = sorted(m for m in sys.modules if m.split(".")[0] in (
    "onnx", "onnxscript") or m.startswith("google.protobuf"))
ref_pkg = sorted(m for m in sys.modules if m.split(".")[0] == "diffsvc_tpu")
print(json.dumps({{"jax": "jax" in sys.modules, "ref_pkg": ref_pkg,
                  "forbidden": forbidden, "onnx": onnx_ok, "pt2": pt2_ok,
                  "n": int(len(wav)), "finite": bool(np.isfinite(wav).all()
                                                     and np.isfinite(wav1).all()
                                                     and np.isfinite(fwav).all()),
                  "batches": len(n_batches), "mels": n_mels, "mcd": mcd}}))
"""


def test_port_never_imports_jax(tmp_path):
    """``import diffsvc_tpu_torch``, its training modules, its entry points
    (``run``, ``binarize``, ``batch``, ``flask_api``), the serving modules
    (``infer.fused``, ``infer.streaming``), the data-parallel process
    group (``parallel.dist``), the FS2-full and FFT-denoiser modules
    (``models.tts_modules``, ``models.candidate_decoder``) and the rest of
    conversion
    (``ops.crepe``, ``models.pe``, ``models.contentvec``,
    ``vocoders.hifigan``, ``vocoders.vocoder_utils``), the other vocoder
    families and GAN training (``vocoders.istft_head``, ``pwg``,
    ``melgan``, ``pqmf``, ``source``, ``discriminators``, ``ops.istft``,
    ``loudness``, ``stft_loss``, ``training.vocoder_task``) and of training and
    data (``training.pe_task``, ``losses``, ``test_runner``, ``ops.ssim``,
    ``ops.cwt``, ``data.textgrid``, ``utils.misc`` and the other copies),
    plus tiny CPU conversions through the port's Svc (CREPE asked for,
    falling back without weights; DDPM at acc=1), one through the fused
    program, a batched binarize (the tiny HuBERT's ``encode_batch``) and
    ``--infer`` on its test split, and the ONNX export (``onnx.*``,
    ``onnx_export``; the tiny project's four graphs written and one run),
    and the compiled-program export (``infer.export``, ``run_exported``,
    ``simplify``, the op library's registered K1-K3; the tiny project's
    ``.pt2`` set written and its denoiser reloaded and run), and the
    learned-score tools (``tools.train_demo``, ``tools.sampler_quality``,
    ``synth.make_dataset``'s clips written), and the vocoder's
    learned-quality tools and the train-stream A/B (``tools.train_istft``,
    ``ab_vocoder``, ``ab_train_stream``; a clip and a batch made), and the
    one-command drive, the mel-MCD metric and the step's repeat check
    (``tools.verify_drive``, ``compare_mel``, ``step_repeat``; the drive's
    songs written, an MCD read), in a fresh process: neither
    jax nor any module of the JAX package ``diffsvc_tpu`` may be in
    sys.modules, nor ``onnx``, ``onnxscript`` or ``google.protobuf``."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c",
         SCRIPT.format(tests=os.path.join(REPO, "tests"))],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res == {"jax": False, "ref_pkg": [], "forbidden": [], "onnx": True,
                   "pt2": True, "n": res["n"], "finite": True,
                   "batches": res["batches"], "mels": 5, "mcd": 0.0}
    assert res["n"] > 0 and res["batches"] > 0


@pytest.mark.parametrize("f0_flags", [["--no_crepe"], []],
                         ids=["no_crepe", "default"])
def test_infer_cli_main_writes_results(in_root, monkeypatch, f0_flags):
    """``python -m diffsvc_tpu_torch.infer_cli`` end to end (in process):
    the flags of infer.py, output under ./results with the input's length.
    CREPE is the default (without its weights here, the AC tracker), the
    AC tracker with ``--no_crepe``."""
    from diffsvc_tpu_torch.infer import hubert_encoder

    _, cfg_fn, ckpt, wav_fn = in_root
    monkeypatch.setattr(hubert_encoder.Hubertencoder, "encode",
                        lambda self, w: fake_units(w))
    infer_cli.main(["--project", "proj", "--model", ckpt, "--config", cfg_fn,
                    "--files", wav_fn, "--key", "3", "--acc", "10",
                    "--device", "cpu", *f0_flags])
    out = "results/in_3key_proj_32_4_1k_10x.wav"
    got, sr = load_wav(out)
    src, _ = load_wav(wav_fn)
    assert sr == SR and len(got) == len(src) and np.abs(got).max() > 1e-3


def test_crepe_and_pe_requests_raise(in_root, tmp_path):
    """Asking for CREPE or pe now runs them where their weights are
    installed.  What still raises: a CREPE checkpoint that exists but cannot
    be read (only missing weights fall back to the AC tracker, as in the
    JAX package; tests/test_torch_crepe.py).  A pe checkpoint that cannot be
    read leaves the conditioner's f0, as the JAX facade does; a readable
    one gives the vocoder pe's f0."""
    from diffsvc_tpu_torch.data import features
    from diffsvc_tpu_torch.utils import synth

    _, cfg_fn, ckpt, wav_fn = in_root
    wav = voiced_wav(secs=0.5)
    bad = tmp_path / "full.pth"
    bad.write_bytes(b"not a checkpoint")
    with pytest.raises(Exception) as err:
        features.get_pitch(wav, np.zeros((1 + len(wav) // HOP, 16)),
                           dict(TINY_HP, crepe_path=str(bad)), use_crepe=True)
    assert not isinstance(err.value, (ImportError, FileNotFoundError))
    svc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
    svc.hubert.encode = fake_units
    svc.hp["crepe_path"] = str(bad)
    with pytest.raises(Exception) as err:
        svc.infer(wav_fn, key=0, acc=10, use_pe=False, use_crepe=True)
    assert not isinstance(err.value, (ImportError, FileNotFoundError))
    nsf = "diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN"
    # pe weights installed: use_pe takes the vocoder's f0 from pe
    pe_cfg, pe_ckpt = synth.write_project(
        str(tmp_path / "proj_pe"), dict(TINY_HP, vocoder=nsf), TINY_VOC,
        pe=True)
    svc = TSvc("proj_pe", pe_cfg, False, pe_ckpt, device="cpu")
    svc.hubert.encode = fake_units
    assert svc.pe is not None
    _, f0_pe, _ = svc.infer(wav_fn, key=0, acc=10, use_pe=True,
                            use_crepe=False)
    _, f0_fs2, _ = svc.infer(wav_fn, key=0, acc=10, use_pe=False,
                             use_crepe=False)
    assert f0_pe.shape == f0_fs2.shape and not np.allclose(f0_pe, f0_fs2)
    # a pe checkpoint directory without a readable checkpoint
    os.makedirs(tmp_path / "pe")
    bad_cfg, bad_ckpt = synth.write_project(
        str(tmp_path / "proj_bad"),
        dict(TINY_HP, vocoder=nsf,
             pe_ckpt=str(tmp_path / "pe" / "model_ckpt_steps_1.ckpt")),
        TINY_VOC)
    svc = TSvc("proj_bad", bad_cfg, False, bad_ckpt, device="cpu")
    svc.hubert.encode = fake_units
    assert svc.pe is None
    _, f0_pred, _ = svc.infer(wav_fn, key=0, acc=10, use_pe=True,
                              use_crepe=False)
    assert np.isfinite(f0_pred).all()


def test_entry_points_never_fall_back_to_the_cpu(in_root, monkeypatch):
    """Without a card, ``default_device`` and every entry point that runs
    on it by default raise (among them the server's and the folder
    batch's ``main``, the pe task, ``--infer``, the learned-score tools,
    the one-command drive and the mel-MCD metric's wav path);
    ``device="cpu"`` (``--device cpu``) runs."""
    from _torch_fixtures import TINY_HP
    from diffsvc_tpu_torch import batch as tbatch
    from diffsvc_tpu_torch import flask_api
    from diffsvc_tpu_torch.config import HParams
    from diffsvc_tpu_torch.data.binarizer import binarize
    from diffsvc_tpu_torch.infer.svc import default_device
    from diffsvc_tpu_torch.run import device_arg, run_task
    from diffsvc_tpu_torch.tools import (ab_train_stream, ab_vocoder,
                                         compare_mel, sampler_quality,
                                         step_repeat, train_demo,
                                         train_istft, verify_drive)
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask
    from diffsvc_tpu_torch.training.task import SVCTask

    _, cfg_fn, ckpt, wav_fn = in_root
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hp = HParams(dict(TINY_HP, task_cls="SVCTask", lr=1e-3,
                      scheduler="step_lr", decay_steps=100))
    for call in (default_device, lambda: default_device("cuda"),
                 lambda: TSvc("proj", cfg_fn, False, ckpt),
                 lambda: SVCTask(hp),
                 lambda: PitchExtractionTask(hp),
                 lambda: run_task(HParams(dict(hp, work_dir="w"))),
                 lambda: run_task(HParams(dict(hp, work_dir="w",
                                               infer=True))),
                 lambda: binarize(hp),
                 lambda: infer_cli.main(["--project", "proj", "--model", ckpt,
                                         "--config", cfg_fn, "--files",
                                         wav_fn]),
                 lambda: infer_cli.main(["--project", "proj", "--model", ckpt,
                                         "--config", cfg_fn, "--files",
                                         wav_fn, "--fused"]),
                 lambda: flask_api.main(["--project", "proj", "--model", ckpt,
                                         "--config", cfg_fn, "--fused"]),
                 lambda: tbatch.main(["--project", "proj", "--model", ckpt,
                                      "--config", cfg_fn]),
                 lambda: train_demo.main(["--tiny", "--out", "demo_out"]),
                 lambda: sampler_quality.main(["--tiny", "--out", "sq_out"]),
                 lambda: train_istft.main(["--tiny", "--out", "ti_out"]),
                 lambda: ab_vocoder.main(["--tiny", "--out", "ab_out"]),
                 lambda: ab_train_stream.main(["--tiny", "--out",
                                               "ts_out"]),
                 lambda: step_repeat.main(["--tiny", "--out", "sr_out"]),
                 lambda: verify_drive.main([]),
                 lambda: verify_drive.main(["--full"]),
                 lambda: compare_mel.main([wav_fn, wav_fn, "--config",
                                           cfg_fn])):
        with pytest.raises(RuntimeError, match="--device cpu"):
            call()
    assert default_device("cpu") == torch.device("cpu")
    assert SVCTask(hp, device="cpu").device.type == "cpu"
    assert TSvc("proj", cfg_fn, False, ckpt, device="cpu").device.type == "cpu"
    assert not os.path.exists("demo_out") and not os.path.exists("sq_out")
    for out in ("ti_out", "ab_out", "ts_out", "sr_out"):
        assert not os.path.exists(out), out
    assert device_arg(["--config", "c.yaml"]) == "cuda"
    assert device_arg(["--config", "c.yaml", "--device", "cpu"]) == "cpu"
