"""Serving soak: minutes of mixed-length, mixed-key POSTs through the
port's HTTP stack, with the programs built after warm-up counted.

The port's counterpart of ``tools/soak_serving.py``.  It drives
``diffsvc_tpu_torch.flask_api.make_handler`` on an ``HTTPServer`` (one
thread: it does all the card's work, as the reference's server has no
concurrency), after ``flask_api.warmup_fused`` has captured every length
bucket up to the mix's longest buffer plus the stream leg's 0.2 s of
context (``:276``), with the JAX tool's client mix: buffer durations
cycled from ``--durs`` and keys from ``--keys`` (``:129-150``), synthetic
PCM16 from :func:`make_wav_bytes`, ``--concurrency`` client threads (they
queue on the server).  Two legs: ``nonstream`` (independent buffers, the
fused route) and ``stream`` (the click-free continuous mode, one client, a
0.5 s buffer).

Per leg: requests, errors (a status other than 200, or an answer whose
wav is not the posted buffer's length), p50 / p95 / p99 overall and per
duration, and ``recompiles_after_warmup``: the JAX name, which here counts
the programs ``FusedSvc`` builds after warm-up (each a CUDA graph captured
on the card; ``fns_growth`` and ``captures_growth`` beside it read
``FusedSvc._fns`` and ``FusedSvc.captures``).  The graph pools' bytes
(``FusedSvc.pool_bytes``) and K2's and K3's launches per leg are written
beside them.  Random weights from a seed at config_44k's widths
(DiffNet 384 x 20, HuBERT-soft 768 x 12, the openvpi NSF-HiFiGAN), acc 50.

Writes ``<out>/summary.json`` (the card's name and power limit beside every
number) and prints one JSON line on stdout; logs go to stderr.

    python -m diffsvc_tpu_torch.tools.soak_serving [--minutes 4]
        [--durs 0.2,0.5,1.0,3.0] [--keys -5,0,3,12] [--concurrency 2]
        [--warmup-seconds S] [--out DIR] [--device cpu]

It runs on the card and raises without one; ``--device cpu`` asks for the
CPU at tiny widths (DiffNet 32 x 4, HuBERT 32 x 2, a 64-channel vocoder).
"""

from __future__ import annotations

import argparse
import contextlib
import http.client
import io
import json
import os
import sys
import threading
import time
import uuid
from types import SimpleNamespace

import numpy as np

from ..utils import devtime
from .train_demo import REPO, device_info, kernels_ready, log

SR, HOP, NFFT, NMEL = 44100, 512, 2048, 128


def pct(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if xs else None


def make_wav_bytes(dur_s, sr, seed):
    """Synthetic vocal-ish PCM16 wav bytes at the model rate (the JAX
    tool's, ``:68-80``)."""
    from scipy.io import wavfile

    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * dur_s)) / sr
    f0 = rng.uniform(150, 330) * (1 + 0.03 * np.sin(2 * np.pi * 5.0 * t))
    ph = np.cumsum(2 * np.pi * f0 / sr)
    w = (0.3 * np.sin(ph) + 0.15 * np.sin(2 * ph)
         + 0.02 * rng.randn(len(t))).astype(np.float32)
    buf = io.BytesIO()
    wavfile.write(buf, sr, (np.clip(w, -1, 1) * 32767).astype(np.int16))
    return buf.getvalue()


def widths(tiny: bool) -> dict:
    """DiffNet, conditioner, HuBERT and vocoder widths (``:220-223``), or
    the CPU run's (the JAX tool's ``--smoke`` widths, with a tiny HuBERT)."""
    if tiny:
        return dict(C=32, L=4, H=32, voc=64,
                    hubert=dict(dim=32, num_heads=2, num_layers=2,
                                ffn_dim=64, proj_dim=32))
    return dict(C=384, L=20, H=256, voc=512, hubert={})


def serving_hp(w: dict, acc: int, **extra) -> dict:
    """The JAX tool's serving hparams (``:225-239``): the wire flags set
    before the program is built (``FusedSvc`` snapshots hp)."""
    hp = dict(
        audio_sample_rate=SR, audio_num_mel_bins=NMEL, fft_size=NFFT,
        hop_size=HOP, win_size=NFFT, fmin=40, fmax=16000,
        hidden_size=w["H"], residual_layers=w["L"],
        residual_channels=w["C"], dilation_cycle_length=4, timesteps=1000,
        K_step=1000, diff_loss_type="l2", schedule_type="linear",
        max_beta=0.02, keep_bins=NMEL, spec_min=[-5.0], spec_max=[0.0],
        no_fs2=True, use_pitch_embed=True, use_energy_embed=False,
        use_spk_id=False, use_spk_embed=False, use_uv=False,
        pitch_norm="log", f0_bin=256, f0_min=40.0, f0_max=1100.0,
        pndm_speedup=acc, use_nsf=True, vocoder="NsfHifiGAN",
        fused_bucket_samples=HOP * 32, fused_output_int16=True,
        fused_input_int16=True)
    hp.update(extra)
    return hp


def random_fused(hp: dict, w: dict, device, acc: int):
    """A ``FusedSvc`` on random weights drawn from seeds 0 (diffusion), 1
    (HuBERT-soft) and 2 (the NSF-HiFiGAN at the openvpi geometry)."""
    import torch

    from ..config import HParams
    from ..infer.fused import FusedSvc
    from ..models.diffusion import GaussianDiffusion
    from ..models.hubert import HubertConfig, HubertSoft
    from ..utils.synth import randomize
    from ..vocoders.generator import Generator, HifiGanConfig

    hp = HParams(hp)
    model = GaussianDiffusion(hp)
    randomize(model, 0)
    hubert = HubertSoft(HubertConfig(**w["hubert"]))
    randomize(hubert, 1)
    gen = Generator(HifiGanConfig(
        num_mels=NMEL, upsample_initial_channel=w["voc"],
        upsample_rates=(8, 8, 2, 2, 2),
        upsample_kernel_sizes=(16, 16, 4, 4, 4), resblock="1",
        resblock_kernel_sizes=(3, 7, 11),
        resblock_dilation_sizes=((1, 3, 5),) * 3, sampling_rate=SR,
        use_nsf=True))
    randomize(gen, 2)
    with torch.no_grad():
        model, hubert, gen = (m.to(device).eval() for m in (model, hubert,
                                                            gen))
    return FusedSvc(hp, model, SimpleNamespace(gen=gen, cfg=gen.cfg), hubert,
                    speedup=acc)


class SvcLike:
    """What ``flask_api`` reads of an ``Svc`` (``hp``, ``infer_fused``,
    ``fused_model``), over one ``FusedSvc``."""

    def __init__(self, fused):
        self.hp = fused.hp
        self._fused = fused

    def fused_model(self, acc: int = 20, compute_dtype=None):
        return self._fused

    def infer_fused(self, wav, key: int = 0, acc: int = 20, seed: int = 0,
                    use_gt_mel: bool = False, add_noise_step: int = 500):
        import torch

        gen = torch.Generator(device=self._fused.device).manual_seed(
            int(seed))
        return self._fused(np.asarray(wav), gen, key_shift=int(key),
                           use_gt_mel=use_gt_mel,
                           add_noise_step=add_noise_step)

    def programs(self) -> dict:
        """The programs built (``FusedSvc._fns``) and, on the card, the
        CUDA graphs captured."""
        return {"fns": len(self._fused._fns),
                "captures": sum(self._fused.captures.values())}


def post(port, wav_bytes, key, daw_sr, timeout=600.0):
    """One multipart POST (the JAX tool's, ``:84-104``); returns (status,
    the answer's samples or its byte count when it is no wav, wall s)."""
    from scipy.io import wavfile

    boundary = uuid.uuid4().hex
    parts = []
    for name, val in (("fPitchChange", str(key)), ("sampleRate", str(daw_sr))):
        parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                     f"name=\"{name}\"\r\n\r\n{val}\r\n".encode())
    parts.append(f"--{boundary}\r\nContent-Disposition: form-data; "
                 f"name=\"sample\"; filename=\"b.wav\"\r\nContent-Type: "
                 f"audio/wav\r\n\r\n".encode() + wav_bytes + b"\r\n")
    parts.append(f"--{boundary}--\r\n".encode())
    body = b"".join(parts)
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=timeout)
    t0 = time.time()
    conn.request("POST", "/voiceChangeModel", body=body, headers={
        "Content-Type": f"multipart/form-data; boundary={boundary}"})
    resp = conn.getresponse()
    data = resp.read()
    wall = time.time() - t0
    conn.close()
    n = len(data)
    if resp.status == 200:
        with contextlib.suppress(ValueError, EOFError):
            n = len(wavfile.read(io.BytesIO(data))[1])
    return resp.status, n, wall


def run_leg(name, model, acc, durs, keys, seconds, concurrency,
            stream=False):
    """One leg on a fresh server; returns its record."""
    from http.server import HTTPServer

    from .. import flask_api

    stream_obj = (flask_api.make_stream(model, acc, fused=True)
                  if stream else None)
    handler = flask_api.make_handler(model, acc, fused=True,
                                     stream=stream_obj)
    server = HTTPServer(("127.0.0.1", 0), handler)
    port = server.server_address[1]
    th = threading.Thread(target=server.serve_forever, daemon=True)
    th.start()

    sr = model.hp["audio_sample_rate"]
    before = model.programs()
    launches = devtime.launches()
    lat = {d: [] for d in durs}
    errors = []
    stop_t = time.time() + seconds
    lock = threading.Lock()
    counter = [0]

    def client():
        while time.time() < stop_t:
            with lock:
                i = counter[0]
                counter[0] += 1
            # the stream leg keeps one duration (a DAW posts fixed
            # buffers); the other cycles the mix
            d = durs[0] if stream else durs[i % len(durs)]
            k = keys[i % len(keys)]
            try:
                status, n, wall = post(port, make_wav_bytes(d, sr, seed=i),
                                       k, sr)
            except (OSError, http.client.HTTPException) as e:
                status, n = "exc", repr(e)     # an error of the leg
            with lock:
                if status != 200 or n != int(sr * d):
                    errors.append((d, k, status, n))
                else:
                    lat[d].append(wall)

    threads = [threading.Thread(target=client)
               for _ in range(1 if stream else concurrency)]
    t0 = time.time()
    for c in threads:
        c.start()
    for c in threads:
        c.join()
    elapsed = time.time() - t0
    server.shutdown()
    server.server_close()
    th.join(timeout=60)
    after = model.programs()

    def ms(v, q):
        return pct(v, q) * 1e3

    allv = [x for v in lat.values() for x in v]
    leg = {
        "requests": len(allv) + len(errors), "errors": len(errors),
        "elapsed_s": elapsed, "concurrency": len(threads),
        # a program built is a new _fns entry, and on the card a capture
        "recompiles_after_warmup": max(after["fns"] - before["fns"],
                                       after["captures"] - before["captures"]),
        "fns_growth": after["fns"] - before["fns"],
        "captures_growth": after["captures"] - before["captures"],
        "launches": {k: v for k, v in devtime.launched(launches).items()
                     if k in ("K2", "K3")},
        "overall": {"p50_ms": ms(allv, 50), "p95_ms": ms(allv, 95),
                    "p99_ms": ms(allv, 99)} if allv else None,
        "per_dur": {str(d): {"n": len(v), "p50_ms": ms(v, 50),
                             "p95_ms": ms(v, 95), "p99_ms": ms(v, 99)}
                    for d, v in lat.items() if v},
        "first_errors": [str(e) for e in errors[:3]],
    }
    log(f"| leg {name}: {leg['requests']} reqs in {elapsed:.0f}s, "
        f"{len(errors)} errors, {leg['recompiles_after_warmup']} programs "
        f"built after warm-up, overall p50/p95/p99 = "
        + (f"{leg['overall']['p50_ms']:.1f}/{leg['overall']['p95_ms']:.1f}/"
           f"{leg['overall']['p99_ms']:.1f} ms" if allv else "n/a"))
    return leg


def soak(fused, args, durs, keys) -> dict:
    """Warm-up, then both legs, on one ``FusedSvc``; returns the summary's
    measured part."""
    from .. import flask_api

    model = SvcLike(fused)
    # every bucket the mix can hit, and the stream leg's [context ++
    # buffer] window, which pushes into the next bucket
    max_d = (max(durs) + 0.2 if args.warmup_seconds is None
             else args.warmup_seconds)
    t0 = time.time()
    n_buckets = flask_api.warmup_fused(model, args.acc, max_d)
    warmup_s = time.time() - t0
    log(f"| warmup: {n_buckets} buckets up to {max_d:.2f} s in "
        f"{warmup_s:.1f}s")
    pools = fused.pool_bytes()
    seconds = args.minutes * 60.0
    legs = {"nonstream": run_leg("nonstream", model, args.acc, durs, keys,
                                 seconds, args.concurrency),
            "stream": run_leg("stream", model, args.acc, [0.5], keys,
                              seconds, 1, stream=True)}
    return {"warmup_buckets": n_buckets, "warmup_max_s": max_d,
            "warmup_s": warmup_s,
            "pool_bytes": {str(k[0]): v for k, v in pools.items()},
            "pool_bytes_total": sum(pools.values()), "legs": legs}


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--minutes", type=float, default=4.0,
                    help="soak duration per leg")
    ap.add_argument("--acc", type=int, default=50)
    ap.add_argument("--durs", default="0.2,0.5,1.0,3.0")
    ap.add_argument("--keys", default="-5,0,3,12")
    ap.add_argument("--concurrency", type=int, default=2)
    ap.add_argument("--warmup-seconds", type=float, default=None,
                    help="capture the buckets up to this buffer length "
                    "(default: the longest duration + 0.2 s)")
    ap.add_argument("--out", default=None,
                    help="default runs/torch_soak_serving (--device cpu: "
                    "runs/torch_soak_serving_tiny)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(REPO, "runs", "torch_soak_serving"
                                + ("_tiny" if args.device == "cpu" else ""))
    return args


def run(args) -> dict:
    from ..infer.svc import default_device

    device = default_device(args.device)
    info = device_info(device)
    log(f"| device: {info['device']} ({info['card']})")
    build_s = kernels_ready(device)
    w = widths(device.type != "cuda")
    durs = [float(x) for x in args.durs.split(",")]
    keys = [int(x) for x in args.keys.split(",")]
    fused = random_fused(serving_hp(w, args.acc), w, device, args.acc)
    res = soak(fused, args, durs, keys)
    if device.type == "cuda":
        for name, leg in res["legs"].items():
            if not (leg["launches"]["K2"] and leg["launches"]["K3"]):
                raise RuntimeError(f"leg {name}: K2 and K3 must launch on "
                                   f"the card ({leg['launches']})")
    return {**info, "dims": ("tiny" if device.type != "cuda"
                             else "production 44.1k"),
            "widths": {k: w[k] for k in ("C", "L", "H", "voc")},
            "acc": args.acc, "durs": durs, "keys": keys,
            "minutes_per_leg": args.minutes, "build_s": build_s, **res}


def main(argv=None) -> dict:
    args = parse_args(argv)
    with contextlib.redirect_stdout(sys.stderr):
        summary = run(args)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "summary.json"), "w") as f:
        json.dump(summary, f, indent=1)
    print(json.dumps({"soak": {k: {kk: v[kk] for kk in (
        "requests", "errors", "recompiles_after_warmup", "overall")}
        for k, v in summary["legs"].items()}}))
    return summary


if __name__ == "__main__":
    main()
