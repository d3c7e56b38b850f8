"""The one-command drive of the port's command lines: binarize -> train ->
convert, end to end, on a project written from a seed.

The port's counterpart of ``tools/verify_drive.py`` (the verify skill's
fast path).  In a fresh ``tempfile.mkdtemp()`` it writes synthetic singing
and a project with random weights (``utils/synth.write_project``), then
runs the port's own entry points in this process, as ``runpy`` runs them
from the command line, so the kernels' counters add up in one process:

  1. ``python -m diffsvc_tpu_torch.binarize``: ``train.data`` exists;
  2. ``python -m diffsvc_tpu_torch.run`` (4 updates, validation every 2):
     ``model_ckpt_steps_*`` exist; on the card the training stack (K4, or
     K5 as ``diffnet.train_route`` picks) was launched;
  3. ``python -m diffsvc_tpu_torch.infer_cli`` on the song with the trained
     checkpoint (``--key 2 --acc 10``, ``--acc 20`` under ``--full``,
     ``--no_pe --no_crepe``): the output is finite, at the config's rate and
     exactly as long as the input; on the card K2 and K3 were launched;
  4. the warm start: two fresh processes load the kernel library against
     one fresh build root (``ops/hopper/_build.BUILD_ROOT``, set before the
     first ``lib()``); the first must build it (``build_seconds`` set, the
     root gains the library), the second must reuse it (``build_seconds``
     None, the root gains nothing).  On the CPU there is nothing to build.

The default recipe is the JAX drive's, size for size: 8 kHz sine songs with
embedded silences (the slicer has work) and unit sidecars, 16 mel bins,
units of 256, DiffNet 32 x 4, a HiFi-GAN V1 vocoder without the NSF source,
and ``train_matmul_precision: highest`` kept in the config (the port reads
no precision key: its products are true f32).  As there, the conversion's
chunks carry no sidecar and the default recipe has no HuBERT weights, so
step 3 takes its units from a seeded stand-in of the JAX drive's.
``--full`` runs ``configs/config_44k.yaml``'s widths instead: 128 mel,
DiffNet 384 x 20, a HuBERT-soft of 768 x 12 and the openvpi NSF-HiFiGAN at
44.1 kHz, on ``synth.make_dataset`` clips and one song with a silence.

Prints the entry points' own logs, then one JSON summary (each step's
seconds and every kernel's launches in it, :func:`launches`; the scratch
directory, kept for the caller, with the song, the checkpoint and the
output), then ``ALL VERIFY STEPS PASSED``, and exits 0; a failed step
raises.

    python -m diffsvc_tpu_torch.tools.verify_drive [--device cpu] [--full]

It runs on the card and raises without one; ``--device cpu`` asks for the
CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import runpy
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np

from .train_demo import NSF_44K, REPO, device_info

# the JAX drive's widths (tests/test_e2e_infer.py: MEL_BINS, HID, RES_CH,
# LAYERS) and rate
SR, MEL_BINS, HID, RES_CH, LAYERS = 8000, 16, 256, 32, 4
FREQS = (196.0, 220.0, 247.0, 262.0, 294.0, 330.0, 349.0, 392.0)
# HiFi-GAN V1 at the default recipe's rate, upsampling by its hop (64)
V1_TINY = dict(num_mels=MEL_BINS, upsample_initial_channel=32,
               upsample_rates=[4, 4, 4], upsample_kernel_sizes=[8, 8, 8],
               resblock="1", resblock_kernel_sizes=[3],
               resblock_dilation_sizes=[[1, 3]], sampling_rate=SR, n_fft=256,
               win_size=256, hop_size=64, fmin=30, fmax=4000)
FULL_CLIPS = 8            # make_dataset clips under --full
FULL_SONG = ((0.6, 220.0), (0.4, 0.0), (0.6, 262.0))   # (s, Hz; 0 = silence)
EXP = "verifyexp"
PROJECT = "testproj"

# a warm-start child: ops/hopper/_build.py loaded from its file (it needs
# no torch), its build root set before the first lib()
WARM_CHILD = r"""
import importlib.util, json, sys, time
spec = importlib.util.spec_from_file_location("_build", sys.argv[2])
_build = importlib.util.module_from_spec(spec)
spec.loader.exec_module(_build)
_build.BUILD_ROOT = sys.argv[1]
t0 = time.time()
_build.lib()
print(json.dumps({"build_seconds": _build.build_seconds,
                  "load_s": time.time() - t0,
                  "library": _build.library_path()}))
"""


def launches() -> dict:
    """Every kernel's counter: K1 (a denoiser evaluation outside K2:
    validation), K2 (a ladder), K3 (a vocoder tail), K4 (a training stack
    call, forward or backward), K5 (a per-sample backward), K6 (a single
    residual layer, on no path)."""
    from ..ops.hopper import (diffnet_block, diffnet_stack,
                              diffnet_stack_per_sample, diffnet_stack_train,
                              plms_ladder, vocoder_tail)

    return {"K1": diffnet_stack.launches, "K2": plms_ladder.launches,
            "K3": vocoder_tail.launches, "K4": diffnet_stack_train.launches,
            "K5": diffnet_stack_per_sample.launches,
            "K6": diffnet_block.launches}


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"verify_drive: {what}")


def tiny_hp(scratch: str) -> dict:
    """The JAX drive's config (``tools/verify_drive.py:48-74``)."""
    return dict(
        audio_sample_rate=SR, audio_num_mel_bins=MEL_BINS, fft_size=256,
        hop_size=64, win_size=256, fmin=30, fmax=4000, wav2spec_eps=1e-6,
        hidden_size=HID, residual_layers=LAYERS, residual_channels=RES_CH,
        dilation_cycle_length=4, timesteps=50, K_step=50,
        diff_loss_type="l2", schedule_type="linear", max_beta=0.02,
        keep_bins=MEL_BINS, spec_min=[-6.0], spec_max=[1.5],
        no_fs2=True, use_pitch_embed=True, use_energy_embed=False,
        use_spk_id=False, use_spk_embed=False, use_uv=False,
        pitch_norm="log", f0_bin=256, f0_min=50.0, f0_max=1100.0,
        use_nsf=False, use_crepe=False, use_vec=False, vocoder="HifiGAN",
        pe_ckpt="", pe_enable=False, max_frames=42000,
        max_input_tokens=60000, mel_vmin=-6.0, mel_vmax=1.5, num_spk=1,
        binarization_args=dict(with_f0=True, with_hubert=True,
                               with_align=True),
        pndm_speedup=10, debug=False,
        raw_data_dir=os.path.join(scratch, "raw"),
        binary_data_dir=os.path.join(scratch, "binary"),
        speaker_id="verify",
        binarizer_cls="preprocessing.SVCpre.SVCBinarizer",
        task_cls="training.task.SVC_task.SVCTask", max_sentences=2,
        max_tokens=6000, max_updates=4, val_check_interval=2,
        num_sanity_val_steps=1, num_valid_plots=0, num_ckpt_keep=2,
        lr=4e-4, scheduler="step_lr", decay_steps=100,
        optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98, weight_decay=0,
        clip_grad_norm=1, accumulate_grad_batches=1, seed=1234,
        save_ckpt=True, endless_ds=False, ds_workers=0, test_num=2,
        valid_num=0, train_set_name="train", valid_set_name="valid",
        test_set_name="test", train_matmul_precision="highest")


def full_hp(scratch: str) -> dict:
    """config_44k at full width, the JAX drive's schedule and split."""
    return {"base_config": [os.path.join(REPO, "configs", "config_44k.yaml")],
            "raw_data_dir": os.path.join(scratch, "raw"),
            "binary_data_dir": os.path.join(scratch, "binary"),
            "max_updates": 4, "val_check_interval": 2,
            "num_sanity_val_steps": 1, "num_valid_plots": 0,
            "num_ckpt_keep": 2, "use_crepe": False, "endless_ds": False,
            "ds_workers": 0, "test_num": 2, "valid_num": 0,
            "train_matmul_precision": "highest"}


def write_songs(raw: str) -> str:
    """The JAX drive's songs: eight 8 kHz sines, each two 1.2 s tones with
    0.7 s silences, with unit sidecars from ``RandomState(0)``, drawn in the
    JAX drive's order.  Returns song 0's path."""
    from ..utils.audio_io import save_wav

    os.makedirs(raw, exist_ok=True)
    rng = np.random.RandomState(0)
    for i, freq in enumerate(FREQS):
        segs = []
        for _ in range(2):
            t = np.arange(int(SR * 1.2)) / SR
            segs.append(0.4 * np.sin(2 * np.pi * freq * t))
            segs.append(np.zeros(int(SR * 0.7)))
        wav = np.concatenate(segs).astype(np.float32)
        save_wav(wav, os.path.join(raw, f"song{i}.wav"), SR)
        n_units = max(2 * len(wav) // 320, 1)
        np.save(os.path.join(raw, f"song{i}.npy"),
                (rng.randn(n_units, HID) * 0.1).astype(np.float32))
    return os.path.join(raw, "song0.wav")


def write_full_data(raw: str) -> str:
    """``synth.make_dataset``'s clips at 44.1 kHz and one song with a
    silence (no sidecar: HuBERT encodes it).  Returns the song's path."""
    from ..utils import synth
    from ..utils.audio_io import save_wav

    synth.make_dataset(raw, sr=44100, n_clips=FULL_CLIPS)
    sr = 44100
    t = 0.0
    secs = sum(s for s, _ in FULL_SONG)
    wav = np.zeros(int(sr * secs), np.float32)
    for i, (s, f0) in enumerate(FULL_SONG):
        if f0:
            tone = synth.voiced_wav(s, sr, f0, seed=i)
            wav[int(t * sr): int(t * sr) + len(tone)] = tone
        t += s
    fn = os.path.join(raw, "song0.wav")
    save_wav(wav, fn, sr)
    return fn


def make_project(scratch: str, full: bool) -> dict:
    """Data, config and checkpoints under ``scratch``; returns the paths
    (``config``, ``ckpt``: the project's own checkpoint, ``song``)."""
    from ..models.hubert import HubertConfig
    from ..utils import synth

    raw = os.path.join(scratch, "raw")
    if full:
        song = write_full_data(raw)
        cfg, ckpt = synth.write_project(os.path.join(scratch, PROJECT),
                                        full_hp(scratch), NSF_44K,
                                        hubert_cfg=HubertConfig())
    else:
        song = write_songs(raw)
        cfg, ckpt = synth.write_project(os.path.join(scratch, PROJECT),
                                        tiny_hp(scratch), V1_TINY)
    return {"config": cfg, "ckpt": ckpt, "song": song}


def stand_in_units(self, wav_path) -> np.ndarray:
    """The JAX drive's unit stand-in for chunks without a sidecar
    (``tools/verify_drive.py:98-101``): seeded draws, one unit per 320
    samples of the 16 kHz resample."""
    from ..utils.audio_io import load_wav

    wav16, _ = load_wav(wav_path, sr=16000)
    n = max(len(wav16) // 320, 1)
    return (np.random.RandomState(1).randn(n, HID) * 0.1).astype(np.float32)


def run_cli(module: str, argv: list) -> None:
    """``python -m <module> <argv>`` in this process."""
    saved = sys.argv
    sys.argv = [module, *argv]
    try:
        runpy.run_module(module, run_name="__main__", alter_sys=False)
    finally:
        sys.argv = saved


@contextlib.contextmanager
def step(name: str, summary: dict):
    """Times a step and records every kernel's launches made in it."""
    print(f"=== {name} ===", flush=True)
    before, t0 = launches(), time.time()
    rec = summary["steps"][name] = {}
    yield rec
    rec["seconds"] = time.time() - t0
    rec["launches"] = {k: v - before[k] for k, v in launches().items()}


def warm_start(device) -> dict:
    """Two fresh processes load the kernel library against one fresh build
    root: the first must build it, the second reuse it."""
    from ..ops.hopper import _build

    if device.type != "cuda":
        print("warm start: the caller asked for the CPU; there is no kernel "
              "to build", flush=True)
        return {"skipped": "cpu"}
    with tempfile.TemporaryDirectory(prefix="verify_build_") as root:
        out = {}
        for tag in ("cold", "warm"):
            proc = subprocess.run(
                [sys.executable, "-c", WARM_CHILD, root, _build.__file__],
                capture_output=True, text=True, timeout=900)
            check(proc.returncode == 0, f"warm start ({tag}): exit "
                  f"{proc.returncode}\n{proc.stderr[-2000:]}")
            rec = json.loads(proc.stdout.strip().splitlines()[-1])
            rec["files"] = sorted(os.path.relpath(os.path.join(d, f), root)
                                  for d, _, fs in os.walk(root) for f in fs)
            out[tag] = rec
            print(f"warm start {tag}: build_seconds {rec['build_seconds']}, "
                  f"load {rec['load_s']:.2f}s, {len(rec['files'])} files "
                  "under the build root", flush=True)
        cold, warm = out["cold"], out["warm"]
        lib_rel = os.path.relpath(cold["library"], root)
        check(cold["build_seconds"] is not None and lib_rel in cold["files"],
              f"the first process did not build the library: {cold}")
        check(warm["build_seconds"] is None
              and warm["files"] == cold["files"],
              f"the second process did not reuse the build: {warm}")
    return out


def convert(paths: dict, ckpt: str, full: bool, device: str,
            key: int = 2) -> str:
    """Step 3: ``python -m diffsvc_tpu_torch.infer_cli`` on the song with
    ``ckpt`` (without ``full``, the units of the chunks from
    :func:`stand_in_units`); returns the one wav it wrote under
    ./results."""
    from ..infer import hubert_encoder

    argv = ["--project", PROJECT, "--model", ckpt, "--config",
            paths["config"], "--files", paths["song"], "--key", str(key),
            "--acc", "20" if full else "10", "--no_pe", "--no_crepe",
            "--device", device]
    with contextlib.ExitStack() as stack:
        if not full:
            stack.enter_context(mock.patch.object(
                hubert_encoder.Hubertencoder, "encode", stand_in_units))
        run_cli("diffsvc_tpu_torch.infer_cli", argv)
    outs = sorted(glob.glob(os.path.join("results", "*.wav")))
    check(len(outs) == 1, f"infer_cli: outputs {outs}")
    return outs[0]


def drive(args, scratch: str) -> dict:
    """Steps 1-4 in ``scratch`` (the working directory); returns the
    summary."""
    from scipy.io import wavfile

    from ..infer.svc import default_device

    device = default_device(args.device)
    summary = {**device_info(device), "full": bool(args.full),
               "scratch": scratch, "steps": {}}
    paths = make_project(scratch, args.full)
    summary.update(paths)
    dev = ["--device", args.device]

    with step("binarize", summary):
        run_cli("diffsvc_tpu_torch.binarize", ["--config", paths["config"],
                                               *dev])
        binary = os.path.join(scratch, "binary")
        check(os.path.exists(os.path.join(binary, "train.data")),
              f"binarize: no train.data in {os.listdir(binary)}")
        print("binarize OK:", sorted(os.listdir(binary)), flush=True)

    with step("run", summary) as rec:
        run_cli("diffsvc_tpu_torch.run", ["--config", paths["config"],
                                          "--exp_name", EXP, "--reset", *dev])
        work = os.path.join("checkpoints", EXP)
        ckpts = sorted(glob.glob(os.path.join(work, "model_ckpt_steps_*")),
                       key=lambda f: int(f.split("_")[-1].split(".")[0]))
        check(bool(ckpts), f"run: no checkpoint in {os.listdir(work)}")
        print("train OK:", [os.path.basename(c) for c in ckpts], flush=True)
        summary["trained_ckpt"] = os.path.abspath(ckpts[-1])
    if device.type == "cuda":
        moved = rec["launches"]["K4"] + rec["launches"]["K5"]
        check(moved > 0, f"run: the training stack was not launched "
              f"{rec['launches']}")

    with step("infer_cli", summary) as rec:
        out = convert(paths, summary["trained_ckpt"], args.full, args.device)
        rate, data = wavfile.read(out)
        sr_in, wav_in = wavfile.read(paths["song"])
        rec.update(output=os.path.abspath(out), sr=int(rate),
                   samples=int(len(data)), input_samples=int(len(wav_in)))
        print(f"infer OK: {os.path.basename(out)} sr={rate} "
              f"len_ratio={len(data) / len(wav_in):.4f}", flush=True)
    check(rate == sr_in, f"infer_cli: rate {rate} against {sr_in}")
    check(bool(np.isfinite(data.astype(np.float64)).all()),
          "infer_cli: non-finite output")
    check(len(data) == len(wav_in), f"infer_cli: {len(data)} samples against "
          f"the input's {len(wav_in)}")
    if device.type == "cuda":
        check(rec["launches"]["K2"] > 0 and rec["launches"]["K3"] > 0,
              f"infer_cli: K2 or K3 was not launched {rec['launches']}")

    with step("warm_start", summary) as rec:
        rec.update(warm_start(device))
    return summary


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--full", action="store_true",
                    help="config_44k's widths (the card's run)")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)
    from ..infer.svc import default_device

    default_device(args.device)      # no card and no --device cpu: raise
    scratch = tempfile.mkdtemp(prefix="verify_scratch_")
    cwd = os.getcwd()
    os.chdir(scratch)
    try:
        summary = drive(args, scratch)
    finally:
        os.chdir(cwd)
    print(json.dumps(summary), flush=True)
    print("ALL VERIFY STEPS PASSED", flush=True)
    return summary


if __name__ == "__main__":
    main()
