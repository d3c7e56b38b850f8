"""Batch inference CLI: slice long audio at silences, convert each chunk,
concatenate (counterpart of the repository's ``infer.py``; reference
``infer.py``).

Usage:
    python -m diffsvc_tpu_torch.infer_cli --project <name> \\
        --model checkpoints/<name>/model_ckpt_steps_N.ckpt \\
        --config checkpoints/<name>/config.yaml --files song.wav --key 0

The model runs on the card; ``--device cpu`` asks for the CPU (there is no
fallback).  As infer.py: CREPE f0 unless ``--no_crepe`` (without CREPE's
weights it falls back to the AC tracker; ``--crepe`` is accepted and
changes nothing), pe on the 24 kHz profile unless ``--no_pe``, and
``--acc 1`` samples with DDPM.  ``--fused`` converts each chunk through the
fused program (one CUDA graph per length bucket; in-program AC f0, no pe),
``--batch_chunks`` converts the voiced chunks in batched device calls,
``--crossfade_ms`` blends the chunk seams.  ``--trace PATH`` records the
program's spans and counters (``utils/trace.py``) and writes them to PATH
as Chrome-trace JSON (chrome://tracing, Perfetto): where a song's time
goes, by span.
"""

from __future__ import annotations

import argparse
import io
import math
import os
import time
from pathlib import Path

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly

from .infer import slicer
from .infer.svc import Svc, get_md5, read_temp, write_temp
from .utils import trace
from .utils.audio_io import format_wav, load_wav, save_wav

CHUNKS_CACHE = "./infer_tools/new_chunks_temp.json"


def crossfade_concat(pieces):
    """Overlap-add chunk waveforms with linear crossfades at the seams.

    pieces: (audio, ov_left, ov_right) per chunk, how far it was extended
    into its neighbours.  At each seam the overlap is the previous piece's
    right extension plus this piece's left one (the pieces cover
    [a - ov_l, b + ov_r] of contiguous [a, b] spans), so both are blended.
    """
    if not pieces:
        return np.zeros(0, np.float32)
    out = np.asarray(pieces[0][0], np.float32).copy()
    prev_ov_r = pieces[0][2]
    for audio, ov_l, ov_r in pieces[1:]:
        audio = np.asarray(audio, np.float32)
        ov = min(prev_ov_r + ov_l, len(out), len(audio))
        if ov > 0:
            ramp = np.linspace(0.0, 1.0, ov, dtype=np.float32)
            out[-ov:] = out[-ov:] * (1 - ramp) + audio[:ov] * ramp
            out = np.concatenate([out, audio[ov:]])
        else:
            out = np.concatenate([out, audio])
        prev_ov_r = ov_r
    return out


def _wav_buffer(data, sr) -> io.BytesIO:
    buf = io.BytesIO()
    wavfile.write(buf, sr, data.astype(np.float32))
    buf.seek(0)
    return buf


def run_clip(svc_model, key, acc, use_pe, use_crepe, thre, use_gt_mel,
             add_noise_step, project_name="", f_name=None, file_path=None,
             out_path=None, slice_db=-40, audio_format="wav", step=0,
             seed=0, crossfade_ms: float = 0.0, batch_chunks: bool = False,
             fused: bool = False):
    """Convert one file chunk by chunk; returns (f0_gt, f0_pred, audio) and
    writes the wav to ``out_path`` (default ./results/...).

    ``fused``: each voiced chunk through ``Svc.infer_fused`` (buckets of
    ``fused_bucket_samples``, by default hop x 256 samples; ``use_pe`` and
    ``batch_chunks`` are ignored).  ``batch_chunks``: the voiced chunks
    through ``Svc.infer_batched``.  ``crossfade_ms``: each voiced chunk is
    extended into its neighbours by that much and the seams blended; the
    output is trimmed to the input's duration.

    Spans (``utils/trace.py``): ``cli.song`` around the call, and under it
    ``cli.read``, ``cli.slice``, ``cli.split``, ``cli.assemble`` and
    ``cli.write`` (the chunk cache's and the output's); the batched
    conversion sits between ``cli.split`` and ``cli.assemble``, the
    per-chunk routes' inside ``cli.assemble``."""
    with trace.span("cli.song"):
        hp = svc_model.hp
        use_pe = use_pe if hp["audio_sample_rate"] == 24000 else False
        if fused:
            hp.setdefault("fused_bucket_samples", int(hp["hop_size"]) * 256)
            if use_pe or batch_chunks:
                print("| WARNING: --fused ignores use_pe/--batch_chunks")
                use_pe, batch_chunks = False, False
        raw_audio_path = f"./raw/{f_name}" if file_path is None else file_path
        clean_name = Path(raw_audio_path).stem
        with trace.span("cli.read"):
            wav_path = format_wav(raw_audio_path)
            chunks_dict = read_temp(CHUNKS_CACHE)
            audio, _ = load_wav(wav_path, mono=True)
            wav_hash = get_md5(audio)
        if wav_hash in chunks_dict:
            print("load chunks from temp")
            chunks = chunks_dict[wav_hash]["chunks"]
        else:
            with trace.span("cli.slice"):
                chunks = slicer.cut(wav_path, db_thresh=slice_db)
        chunks_dict[wav_hash] = {"chunks": chunks, "time": int(time.time())}
        with trace.span("cli.write", what="chunk_cache"):
            write_temp(CHUNKS_CACHE, chunks_dict)
        sr_out = int(hp["audio_sample_rate"])

        with trace.span("cli.split"):
            audio_data, audio_sr = slicer.chunks2audio(wav_path, chunks)
            # crossfade: each chunk extended into its neighbours by the
            # overlap
            ov_in = int(audio_sr * crossfade_ms / 1000)
            if ov_in > 0:
                spans = [tuple(map(int, v["split_time"].split(",")))
                         for v in dict(chunks).values()]
                audio_data = []
                for (a, b), v in zip(spans, dict(chunks).values()):
                    a2, b2 = max(0, a - ov_in), min(len(audio), b + ov_in)
                    audio_data.append((v["slice"], audio[a2:b2], a - a2,
                                       b2 - b))
            else:
                audio_data = [(tag, data, 0, 0) for tag, data in audio_data]
            voiced = [i for i, (tag, _, _, _) in enumerate(audio_data)
                      if not tag]
            if batch_chunks:
                bufs = [_wav_buffer(audio_data[i][1], audio_sr)
                        for i in voiced]

        batched = None
        if batch_chunks:
            res = svc_model.infer_batched(
                bufs, key=key, acc=acc, use_pe=use_pe, use_crepe=use_crepe,
                thre=thre, seed=seed)
            batched = dict(zip(voiced, res))

        with trace.span("cli.assemble"):
            pieces, expected_total = [], 0
            f0_tst, f0_pred, out_audio = [], [], []
            for chunk_i, (slice_tag, data, ov_l, ov_r) in enumerate(
                    audio_data):
                print(f"#=====segment start, "
                      f"{round(len(data) / audio_sr, 3)}s======")
                # output samples for this chunk: ceil(len * sr_out / sr_in)
                # in integers (the float form of infer.py can add a sample
                # per chunk, e.g. 44000 / 8000 * 8000 = 44000.000000000004)
                length = -(-len(data) * sr_out // int(audio_sr))
                if slice_tag:
                    print("jump empty segment")
                    n_frames = -(-length // int(hp["hop_size"]))
                    _f0_tst, _f0_pred, _audio = (np.zeros(n_frames),
                                                 np.zeros(n_frames),
                                                 np.zeros(length))
                elif batched is not None:
                    _f0_tst, _f0_pred, _audio = batched[chunk_i]
                elif fused:
                    from .infer.fused import FusedSvc

                    w = data.astype(np.float32)
                    if int(audio_sr) != sr_out:
                        g = math.gcd(sr_out, int(audio_sr))
                        w = resample_poly(w, sr_out // g, int(audio_sr) // g
                                          ).astype(np.float32)
                    wav_o, f0_o, _ = svc_model.infer_fused(
                        w, key=key, acc=acc, seed=seed, use_gt_mel=use_gt_mel,
                        add_noise_step=add_noise_step)
                    _audio = FusedSvc.to_float(wav_o)
                    _f0_tst = _f0_pred = np.asarray(f0_o)
                else:
                    _f0_tst, _f0_pred, _audio = svc_model.infer(
                        _wav_buffer(data, audio_sr), key=key, acc=acc,
                        use_pe=use_pe, use_crepe=use_crepe, thre=thre,
                        use_gt_mel=use_gt_mel, add_noise_step=add_noise_step,
                        seed=seed)
                # mean-fill length fix (reference infer.py:61-66)
                fix_audio = np.full(length, np.mean(_audio) if len(_audio)
                                    else 0.0)
                fix_audio[: len(_audio)] = _audio[
                    0 if len(_audio) < len(fix_audio)
                    else len(_audio) - len(fix_audio):]
                f0_tst.extend(_f0_tst)
                f0_pred.extend(_f0_pred)
                expected_total += -(-(len(data) - ov_l - ov_r) * sr_out
                                    // int(audio_sr))
                if ov_in > 0:
                    scale = sr_out / audio_sr
                    pieces.append((fix_audio, int(round(ov_l * scale)),
                                   int(round(ov_r * scale))))
                else:
                    out_audio.extend(list(fix_audio))
            if ov_in > 0:
                # trim the extensions so the output matches the input
                # duration
                out_audio = crossfade_concat(pieces)[:expected_total]

        if audio_format != "wav":
            print(f"| WARNING: only wav output is supported; writing wav "
                  f"(requested {audio_format})")
            audio_format = "wav"
        if out_path is None:
            out_path = (f"./results/{clean_name}_{key}key_{project_name}_"
                        f"{hp['residual_channels']}_{hp['residual_layers']}_"
                        f"{int(step / 1000)}k_{acc}x.{audio_format}")
        with trace.span("cli.write", what="output"):
            save_wav(np.asarray(out_audio), out_path,
                     hp["audio_sample_rate"])
        print(f"| wrote {out_path}")
        return np.array(f0_tst), np.array(f0_pred), out_audio


def main(argv=None):
    ap = argparse.ArgumentParser(description="diffsvc_tpu_torch inference")
    ap.add_argument("--project", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--files", nargs="+", required=True,
                    help="wav files under ./raw or absolute paths")
    ap.add_argument("--key", type=int, nargs="+", default=[0])
    ap.add_argument("--acc", type=int, default=None,
                    help="sampler speedup (default: the config's "
                         "pndm_speedup); 1 samples with DDPM")
    ap.add_argument("--slice_db", type=float, default=-40)
    ap.add_argument("--no_pe", action="store_true")
    crepe = ap.add_mutually_exclusive_group()
    crepe.add_argument("--crepe", action="store_true",
                       help="CREPE f0 (the default; accepted, no effect)")
    crepe.add_argument("--no_crepe", action="store_true",
                       help="the AC f0 tracker instead of CREPE")
    ap.add_argument("--thre", type=float, default=0.05)
    ap.add_argument("--use_gt_mel", action="store_true")
    ap.add_argument("--add_noise_step", type=int, default=500)
    ap.add_argument("--format", default="wav")
    ap.add_argument("--crossfade_ms", type=float, default=0.0,
                    help="blend chunk seams with linear crossfades")
    ap.add_argument("--batch_chunks", action="store_true",
                    help="run same-length chunks as batched device calls")
    ap.add_argument("--fused", action="store_true",
                    help="the fused serving program (one CUDA graph per "
                         "length bucket; in-program AC f0, no crepe/pe)")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default: the card)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="record the program's spans and counters and "
                         "write them to PATH as Chrome-trace JSON")
    args = ap.parse_args(argv)

    model_path = args.model or f"./checkpoints/{args.project}/"
    config_path = args.config or f"./checkpoints/{args.project}/config.yaml"
    step = 0
    if args.model and "steps_" in args.model:
        step = int(args.model.split("_")[-1].split(".")[0])
    for d in ("./raw", "./results", "./infer_tools"):
        os.makedirs(d, exist_ok=True)
    keys = list(args.key)
    keys.extend([keys[0]] * (len(args.files) - len(keys)))

    model = Svc(args.project, config_path, True, model_path,
                device=args.device)
    acc = args.acc if args.acc is not None else int(
        model.hp.get("pndm_speedup", 20) or 20)
    if args.trace:
        trace.enable()
    try:
        for f_name, key in zip(args.files, keys):
            file_path = f_name if os.path.isabs(f_name) \
                or os.path.exists(f_name) else None
            run_clip(model, key=key, acc=acc, use_pe=not args.no_pe,
                     use_crepe=not args.no_crepe, thre=args.thre,
                     use_gt_mel=args.use_gt_mel,
                     add_noise_step=args.add_noise_step,
                     f_name=os.path.basename(f_name), file_path=file_path,
                     project_name=args.project, slice_db=args.slice_db,
                     audio_format=args.format, step=step,
                     crossfade_ms=args.crossfade_ms,
                     batch_chunks=args.batch_chunks, fused=args.fused)
    finally:
        if args.trace:
            trace.disable()
            trace.write_chrome(args.trace)
            print(f"| wrote the trace to {args.trace}")


if __name__ == "__main__":
    main()
