"""Realtime voice-change HTTP service for the DAW/VST plugin.

Counterpart of the repository's ``flask_api.py`` (reference
``flask_api.py``): POST ``/voiceChangeModel`` (multipart ``sample`` wav +
``fPitchChange`` + ``sampleRate``), inference without crepe and pe,
resample to the DAW rate, return a wav.  Port 6842.  On the stdlib
``http.server``.  A decode or argument error answers 400, an inference
error 500.

    python -m diffsvc_tpu_torch.flask_api --project <name> --model <ckpt> \
        --config <config.yaml> [--fused --warmup 3] [--stream] [--device cpu]

The model runs on the card unless ``--device cpu`` asks for the CPU.
``--fused`` serves through the fused program, one CUDA graph per length
bucket of ``fused_bucket_samples`` (hop x 256 by default); ``--warmup S``
captures every bucket up to S seconds before serving.  The optional flask
app factory of the JAX package's server is not ported.
"""

import argparse
import io
import struct
import threading
import time
import traceback
from email.parser import BytesParser
from email.policy import default as email_default_policy
from http.server import BaseHTTPRequestHandler, HTTPServer

import numpy as np
from scipy.io import wavfile

from .infer.svc import Svc
from .utils.audio_io import load_wav, resample


def _convert_floats(model, acc, wav: np.ndarray, f_pitch_change: float,
                    fused: bool) -> np.ndarray:
    """float32 wav @ model sr -> converted float32 wav @ model sr, same
    length. The streaming path needs conversion as a pure array->array
    function (it feeds synthetic [context ++ buffer] windows, not the
    posted bytes)."""
    if fused:
        from .infer.fused import FusedSvc

        model.hp.setdefault("fused_bucket_samples",
                            model.hp["hop_size"] * 256)
        model.hp.setdefault("fused_output_int16", True)
        # the posted audio is PCM16 to begin with, so the int16 input
        # wire (decode on device) is lossless here and halves the
        # host->device copy exactly like the output side
        model.hp.setdefault("fused_input_int16", True)
        audio, _f0, _mel = model.infer_fused(wav, key=int(f_pitch_change),
                                             acc=acc)
        audio = FusedSvc.to_float(audio)
    else:
        buf = io.BytesIO()
        wavfile.write(buf, model.hp["audio_sample_rate"],
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        buf.seek(0)
        _f0_tst, _f0_pred, audio = model.infer(
            buf, key=f_pitch_change, acc=acc, use_pe=False, use_crepe=False)
        audio = np.asarray(audio, np.float32)
    if len(audio) < len(wav):
        audio = np.pad(audio, (0, len(wav) - len(audio)))
    return audio[: len(wav)]


def _stream_response(stream, wav: np.ndarray, f_pitch_change: float
                     ) -> np.ndarray:
    """One streaming request -> exactly ``len(wav)`` output samples.

    StreamingConverter accumulates sub-crossfade buffers internally and
    releases them in bursts, so its per-call output length is NOT the
    posted length. An output FIFO on the stream restores the per-response
    duration contract the VST protocol needs:

    - posted buffers >= one crossfade (the non-accumulating regime):
      the first response is zero-padded at the head by the crossfade
      delay, later responses are full — identical to the pre-FIFO
      behavior;
    - sub-crossfade buffers (256-1024-sample DAW blocks): responses are
      all-zero until roughly TWO accumulation periods of audio are
      queued, then the stream plays continuously. The extra period of
      buffering is what guarantees no mid-stream silence gaps between
      bursts (a head-padded release would starve until the next burst).
      Latency is constant per block size; changing the DAW block size
      mid-stream restarts the fill.
    """
    idle = getattr(stream, "idle_reset_s", 0.0)
    last = getattr(stream, "last_call_t", None)
    if idle and last is not None and time.time() - last > idle:
        # the DAW paused: the held tail/context belong to a take that
        # ended — drop them instead of crossfading stale audio into the
        # new one (the restarted stream re-pays its head-fill delay)
        stream.flush()
        stream.out_queue = np.zeros(0, np.float32)
        stream.emitted_real = False
    stream.pitch = f_pitch_change
    _audio = stream(wav)
    # stamped AFTER converting: a slow first call (a bucket's warm-up and capture)
    # must not read as an idle gap for the request right behind it
    stream.last_call_t = time.time()
    q = np.concatenate([getattr(stream, "out_queue",
                                np.zeros(0, np.float32)), _audio])
    n = len(wav)
    if len(q) >= n:
        out, q = q[:n], q[n:]
        stream.emitted_real = True
    elif len(wav) >= stream.C and not getattr(stream, "emitted_real", False):
        # big-buffer first response: head-fill with the crossfade delay
        # (steady state returns len(wav) per call, so this never starves)
        out = np.concatenate([np.zeros(n - len(q), np.float32), q])
        stream.emitted_real = len(q) > 0
        q = np.zeros(0, np.float32)
    else:
        # sub-crossfade fill: withhold until a full response is queued —
        # emitting a partial burst now would leave a silence gap before
        # the next one
        out = np.zeros(n, np.float32)
    stream.out_queue = q
    return out


def _infer_wav(model, acc, wav: np.ndarray, f_pitch_change: float,
               daw_sample: int, fused: bool = False, stream=None) -> bytes:
    """Decoded float32 wav @ model sr -> response wav bytes @ daw rate.

    Decoding happens in the HTTP handler (so undecodable uploads map to
    4xx and everything here maps to 5xx)."""
    if stream is not None:
        # click-free continuous mode (beyond reference): left context +
        # held-tail crossfade across consecutive DAW buffers
        # (infer/streaming.py). Every response keeps the
        # posted buffer's duration (see _stream_response).
        _audio = _stream_response(stream, wav, f_pitch_change)
    elif fused:
        # bounded-latency path: the whole pipeline is one CUDA graph per
        # length bucket (fused_bucket_samples bounds the number of captured
        # buckets for streaming buffers); int16 device output halves the
        # device->host copy
        _audio = _convert_floats(model, acc, wav, f_pitch_change, fused=True)
    else:
        # modular reference path consumes a wav file object; the posted
        # audio is PCM16 per the VST protocol, so re-encoding the decoded
        # floats is a lossless round trip.  A float or 24-bit upload is
        # quantized to int16 here, as the JAX package's server does (the
        # same request gives the same audio in both)
        buf = io.BytesIO()
        wavfile.write(buf, model.hp["audio_sample_rate"],
                      (np.clip(wav, -1, 1) * 32767).astype(np.int16))
        buf.seek(0)
        _f0_tst, _f0_pred, _audio = model.infer(
            buf, key=f_pitch_change, acc=acc, use_pe=False,
            use_crepe=False)
    tar = resample(np.asarray(_audio, np.float32),
                   model.hp["audio_sample_rate"], daw_sample)
    out = io.BytesIO()
    wavfile.write(out, daw_sample, (np.clip(tar, -1, 1) * 32767).astype(np.int16))
    return out.getvalue()


def make_stream(model, acc, fused=False, context_ms=100.0,
                crossfade_ms=40.0, idle_reset_s=2.0):
    """One StreamingConverter per server — the reference VST protocol is
    one plugin instance per service (ref flask_api.py:19-54), so a single
    stream state matches the use case. ``stream.pitch`` is re-read on
    every converted window, so mid-stream fPitchChange edits take effect
    (smoothed across the crossfade like any other discontinuity).
    ``idle_reset_s`` restarts the stream after a request gap longer than
    that (a paused/stopped DAW): without it, minutes-old context would be
    crossfaded into the head of the next take. 0 disables."""
    from .infer.streaming import StreamingConverter

    def convert(w):
        return _convert_floats(model, acc, w, stream.pitch, fused)

    stream = StreamingConverter(convert, model.hp["audio_sample_rate"],
                                context_ms=context_ms,
                                crossfade_ms=crossfade_ms)
    stream.pitch = 0.0
    stream.idle_reset_s = float(idle_reset_s)
    return stream


def make_handler(model, accelerate, fused=False, stream=None):
    # serializes conversion: the shared StreamingConverter (and a CUDA
    # graph's static buffers) must never interleave two requests — a no-op under
    # the single-threaded HTTPServer, a correctness guard if the server is
    # ever swapped for ThreadingHTTPServer
    infer_lock = threading.Lock()

    class Handler(BaseHTTPRequestHandler):
        def do_POST(self):
            if self.path != "/voiceChangeModel":
                self.send_error(404)
                return
            ctype = self.headers.get("Content-Type", "")
            if "multipart/form-data" not in ctype:
                self.send_error(400, "expected multipart/form-data")
                return
            length = int(self.headers.get("Content-Length", 0))
            raw = self.rfile.read(length)
            msg = BytesParser(policy=email_default_policy).parsebytes(
                b"Content-Type: " + ctype.encode() + b"\r\n\r\n" + raw)
            fields = {}
            wav_bytes = b""
            for part in msg.iter_parts():
                name = part.get_param("name",
                                      header="content-disposition")
                if name == "sample":
                    wav_bytes = part.get_payload(decode=True)
                elif name:
                    fields[name] = part.get_payload(decode=True).decode()
            try:
                f_pitch_change = float(fields.get("fPitchChange", 0))
                daw_sample = int(float(fields.get("sampleRate", 44100)))
            except ValueError:
                self.send_error(400, "fPitchChange/sampleRate not numeric")
                return
            if not np.isfinite(f_pitch_change) or abs(f_pitch_change) > 48:
                self.send_error(
                    400, f"fPitchChange {f_pitch_change} out of range "
                    "(finite, |semitones| <= 48)")
                return
            if daw_sample <= 0:
                self.send_error(400, f"bad sampleRate {daw_sample}")
                return
            if not wav_bytes:
                self.send_error(400, "missing 'sample' file field")
                return
            try:
                # decode SEPARATELY from inference so only undecodable
                # uploads map to 4xx (scipy wavfile raises ValueError /
                # struct.error / KeyError / EOFError depending on where
                # the file is cut); a ValueError raised later inside the
                # model is a server fault and must surface as 500
                wav, _ = load_wav(io.BytesIO(wav_bytes),
                                  sr=model.hp["audio_sample_rate"])
            except (ValueError, EOFError, KeyError, struct.error) as e:
                self.send_error(400, f"bad wav upload: {e}")
                return
            if len(wav) == 0:
                self.send_error(400, "empty wav upload")
                return
            try:
                with infer_lock:
                    body = _infer_wav(model, accelerate, wav,
                                      f_pitch_change, daw_sample,
                                      fused=fused, stream=stream)
            except Exception as e:   # the server keeps serving: report, 500
                traceback.print_exc()
                self.send_error(500, str(e))
                return
            self.send_response(200)
            self.send_header("Content-Type", "audio/wav")
            self.send_header("Content-Disposition",
                             'attachment; filename="temp.wav"')
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, fmt, *args):
            pass

    return Handler


def warmup_fused(model, acc: int, max_seconds: float) -> int:
    """Capture every fused length bucket up to ``max_seconds`` before
    serving, so that no live DAW buffer pays for a bucket's warm-up call
    and capture.  Prints each bucket's time and graph memory; returns the
    number of buckets."""
    sr = model.hp["audio_sample_rate"]
    model.hp.setdefault("fused_bucket_samples", model.hp["hop_size"] * 256)
    model.hp.setdefault("fused_output_int16", True)
    model.hp.setdefault("fused_input_int16", True)
    bucket = int(model.hp["fused_bucket_samples"])
    if bucket <= 0:
        # bucketing disabled (fused_bucket_samples: 0 captures per exact
        # length): warm one max-length buffer
        bucket, n_buckets = int(max_seconds * sr), 1
    else:
        n_buckets = max(int(np.ceil(max_seconds * sr / bucket)), 1)
    for i in range(1, n_buckets + 1):
        t0 = time.time()
        model.infer_fused(np.zeros(i * bucket, np.float32), key=0, acc=acc)
        pools = model.fused_model(acc).pool_bytes()
        mib = max(pools.values(), default=0) / 2 ** 20
        print(f"| warmed bucket {i}/{n_buckets} ({i * bucket / sr:.2f}s "
              f"buffer) in {time.time() - t0:.1f}s; graph pools "
              f"{len(pools)}, this one {mib:.1f} MiB", flush=True)
    return n_buckets


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--project", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--acc", type=int, default=50)
    ap.add_argument("--port", type=int, default=6842)
    ap.add_argument("--fused", action="store_true",
                    help="serve via the fused program (a CUDA graph per "
                         "length bucket)")
    ap.add_argument("--warmup", type=float, default=0.0, metavar="SECONDS",
                    help="with --fused: capture all length buckets up to "
                         "this buffer duration before accepting requests")
    ap.add_argument("--stream", action="store_true",
                    help="click-free continuous mode: convert each buffer "
                         "with left context from the previous one and "
                         "crossfade the seam (adds stream-crossfade-ms of "
                         "latency; beyond the reference service)")
    ap.add_argument("--stream-context-ms", type=float, default=100.0)
    ap.add_argument("--stream-crossfade-ms", type=float, default=40.0)
    ap.add_argument("--stream-idle-reset-s", type=float, default=2.0,
                    help="restart the stream after a request gap longer "
                         "than this (a paused DAW); 0 disables")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)

    model_path = args.model or f"./checkpoints/{args.project}/"
    config_path = args.config or f"./checkpoints/{args.project}/config.yaml"
    model = Svc(args.project, config_path, True, model_path,
                device=args.device)

    if args.warmup > 0:
        if args.fused:
            warmup_fused(model, args.acc, args.warmup)
        else:
            print("| WARNING: --warmup only applies to --fused serving; "
                  "ignored")

    stream = (make_stream(model, args.acc, fused=args.fused,
                          context_ms=args.stream_context_ms,
                          crossfade_ms=args.stream_crossfade_ms,
                          idle_reset_s=args.stream_idle_reset_s)
              if args.stream else None)
    server = HTTPServer(("0.0.0.0", args.port),
                        make_handler(model, args.acc, fused=args.fused,
                                     stream=stream))
    print(f"| serving /voiceChangeModel on :{args.port}")
    server.serve_forever()


if __name__ == "__main__":
    main()
