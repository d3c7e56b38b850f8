"""Offline song conversion: ``diffsvc_tpu_torch.infer_cli.run_clip`` over
whole songs, one after another, as a user converts vocal stems with
``python -m diffsvc_tpu_torch.infer_cli``.

The cell's ``entry_args`` choose the route: ``"route": "fused"`` runs
``run_clip(fused=True)`` (each voiced chunk through ``Svc.infer_fused``),
``"batched"`` runs ``run_clip(batch_chunks=True)`` (``Svc.infer_batched``),
with ``acc``, ``use_pe`` and ``slice_db``.

Set-up: weights from the seed, the ``Svc``, every fused length bucket the
mix can produce converted once (each captured as its CUDA graph), the
window's first three songs' structures with other contents through
``run_clip``, and the songs written as 16-bit wavs.  The
window converts the songs in the seed's order and ends at the first
completion after ``--seconds``.  Then a sample of the completed songs,
drawn from the seed with the longest among them, is converted by the
plain reference from the same input files and noise seeds, and each output
file is compared with it.
"""

from __future__ import annotations

import contextlib
import gc
import math
import os
import shutil
import tempfile
import time

import numpy as np
from scipy.io import wavfile

from benchmark import harness, port, weights
from benchmark.reference import modular as ref_modular
from benchmark.reference import precision
from benchmark.reference import svc as ref_svc


WARM_SONGS = 3


def noise_seed(seed: int, index: int) -> int:
    """The seed ``run_clip`` draws a song's noise from."""
    return (int(seed) * 1000003 + 7919 * int(index)) % (2 ** 31)


def max_chunk_seconds(mix: dict, slice_ms: int = 5000) -> float:
    """The longest voiced chunk the slicer can make of the mix: phrases
    shorter than its 5 s minimum merge with the next, so at most 5 s of
    phrases, a gap, the longest phrase and the silence kept on each
    side."""
    p = mix["pool"]
    return slice_ms / 1000 + 2 * p["gap_s"][1] + p["phrase_s"][1] + 1.0


def warm_wav(n: int, sr: int) -> np.ndarray:
    t = np.arange(n) / sr
    return (0.3 * np.sin(2 * np.pi * 220.0 * t)).astype(np.float32)


def wav_samples(buf) -> int:
    """Samples of a wav held in a BytesIO (the batched route's inputs)."""
    import io

    return len(wavfile.read(io.BytesIO(buf.getvalue()))[1])


def run(r: harness.Run) -> None:
    import torch

    from diffsvc_tpu_torch import infer_cli

    gen = harness.load_module("generators", r.traffic["generator"], r.root)
    args = r.workload["entry_args"]
    r.config = cfg = port.serving(r.config)
    hp = cfg["hparams"]
    sr, route = int(hp["audio_sample_rate"]), args["route"]
    acc = int(args["acc"])
    tmp = tempfile.mkdtemp(prefix="bench_song_")
    cwd = os.getcwd()
    os.chdir(tmp)      # the port's ./infer_tools caches land here
    try:
        _run(r, torch, infer_cli, gen, args, cfg, hp, sr, route, acc, tmp)
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)


def _run(r, torch, infer_cli, gen, args, cfg, hp, sr, route, acc, tmp):
    w = weights.make(cfg, r.seed, r.device)
    svc = port.build_svc(os.path.join(tmp, "project"), cfg, w, r.device,
                         hubert_cfg=cfg["hubert"] if args.get(
                             "hubert_widths_from_config") else None)
    del w
    use_pe = bool(args.get("use_pe", False))
    slice_db = float(args.get("slice_db", -40))

    def convert(path, out, key, seed):
        return infer_cli.run_clip(
            svc, key=key, acc=acc, use_pe=use_pe, use_crepe=False, thre=0.05,
            use_gt_mel=False, add_noise_step=500, file_path=path,
            out_path=out, slice_db=slice_db, seed=seed,
            batch_chunks=route == "batched", fused=route == "fused")

    # spans around the calls run_clip makes into the conversion layer
    call = "infer_fused" if route == "fused" else "infer_batched"
    inner = getattr(svc, call)

    def spanned(*a, **kw):
        info = ({"n": len(a[0])} if route == "fused"
                else {"ns": [wav_samples(b) for b in a[0]]})
        with r.span(call, **info):
            return inner(*a, **kw)

    setattr(svc, call, spanned)
    # set-up: every fused bucket the mix can reach
    if route == "fused":
        bucket = int(hp["hop_size"]) * 256
        svc.hp.setdefault("fused_bucket_samples", bucket)
        bucket = int(svc.hp["fused_bucket_samples"])
        n_max = int(max_chunk_seconds(r.traffic) * sr)
        for k in range(1, -(-n_max // bucket) + 1):
            inner(warm_wav(k * bucket - 1, sr), key=0, acc=acc, seed=0)
    os.makedirs("raw", exist_ok=True)
    os.makedirs("out", exist_ok=True)
    songs = gen.songs(r.traffic, r.seed, sr)
    # the window's first songs' structures, with other contents, through
    # run_clip: the shapes, allocations and host paths the window starts on
    for k, (_, _, song) in enumerate(songs[:WARM_SONGS]):
        audio, _ = gen.render(r.traffic, song, r.seed, 10 ** 6 + k, sr,
                              r.device)
        wavfile.write(f"raw/warm{k}.wav", sr, audio)
        convert(f"raw/warm{k}.wav", f"out/warm{k}.wav", 0, k)
    keys = {}
    for i, (idx, _, song) in enumerate(songs):
        audio, keys[idx] = gen.render(r.traffic, song, r.seed, idx, sr,
                                       r.device)
        with open(f"raw/{idx}.wav", "wb") as f:
            wavfile.write(f, sr, audio)
            # on the disk before the window: no write-back of set-up's
            # files competes with the window's own reads and writes
            f.flush()
            os.fsync(f.fileno())
    spans_before = len(r.spans)

    done = []
    with r.window():
        for idx, secs, _ in songs:
            r.attempted += 1
            ok = True
            with r.span("song", index=idx, seconds=secs):
                try:
                    convert(f"raw/{idx}.wav", f"out/{idx}.wav", keys[idx],
                            noise_seed(r.seed, idx))
                except Exception as e:   # counted, and the run is wrong
                    harness.log(f"song {idx} failed: {e!r}")
                    r.failed += 1
                    ok = False
            t_done = time.perf_counter()
            harness.log(f"song {idx}: {secs:.1f} s of audio done at "
                        f"{t_done - r.t0:.3f} s")
            if ok:
                done.append((idx, secs, t_done))
            if t_done - r.t0 >= r.seconds:
                break
        else:
            raise RuntimeError("the mix's pool ran out before the window "
                               "closed: enlarge its pool")
    window_s = (done[-1][2] if done else time.perf_counter()) - r.t0
    r.e2e["song_audio_rate"] = sum(s for _, s, _ in done) / window_s
    r.counters["window_s"] = window_s
    r.work = [dict(s[3], kind=s[0]) for s in r.spans[spans_before:]
              if s[0] == call]
    harness.log(f"window: {len(done)} songs, {sum(s for _, s, _ in done):.1f}"
                f" s of audio in {window_s:.3f} s; set-up {r.setup_s:.2f} s")

    # the check, on the program's freed card
    setattr(svc, call, inner)
    del svc, inner
    gc.collect()
    if r.device == "cuda":
        torch.cuda.empty_cache()
    check(r, cfg, sr, acc, slice_db, done, keys)


def pick(done: list, seed: int, n: int) -> list:
    """The longest completed song and up to n - 1 others drawn from the
    seed."""
    if not done:
        return []
    longest = max(done, key=lambda d: d[1])
    rest = [d for d in done if d is not longest]
    rng = np.random.default_rng([int(seed) % 2 ** 64, 2])
    extra = [rest[i] for i in rng.permutation(len(rest))[: max(n - 1, 0)]]
    return [longest] + extra


def gap(out: np.ndarray, ref: np.ndarray) -> tuple:
    """(length gap in samples, relative L2 gap) of two 16-bit outputs."""
    n = min(len(out), len(ref))
    d = np.linalg.norm(out[:n].astype(np.float64) - ref[:n])
    return (abs(len(out) - len(ref)),
            d / max(np.linalg.norm(ref[:n].astype(np.float64)), 1.0))


def numbers(out: np.ndarray, refs: list) -> dict:
    """One song's numbers against ``refs`` (the reference's output and,
    where asked, its output with the parts stated below f32 rounded at
    their stated precision): the length gap, the relative L2 gap, and that
    gap over the one the stated precision makes in the reference.  The
    last is the one a random-weight seed does not rescale: how far the
    output of a seed's weights moves for a given rounding swings with the
    weights, 15x from seed to seed, and that scale cancels in it."""
    lg, g = gap(out, refs[0])
    got = {"len_gap": float(lg), "wav_rel_l2": float(g)}
    if len(refs) > 1:
        _, s = gap(refs[1], refs[0])
        got["gap_over_stated"] = float(g / s) if s > 0 else (
            0.0 if g == 0 else math.inf)
    return got


def reference(w, cfg, args, audio, sr, key, acc, seed, device, slice_db,
              lowered=False, scaled=False) -> list:
    """The plain reference's output of one song on the cell's route, and
    with ``scaled`` its output at the configuration's stated precisions
    after it (the fused route's reference gives both over one front
    end)."""
    ctx = precision.lowered(cfg["precision"]) if lowered \
        else contextlib.nullcontext()
    tails = (None, precision.stated_kinds(cfg["precision"])) if scaled \
        else (None,)
    with precision.exact_f32(), ctx:
        if args["route"] == "fused":
            return ref_svc.convert_song(w, cfg, audio, sr, key, acc, seed,
                                        device, slice_db, tails)
        if scaled:
            raise ValueError("the batched route's reference has no stated-"
                             "precision output: compare wav_rel_l2")
        return [ref_modular.convert_song(w, cfg, audio, sr, key, acc, seed,
                                         device, slice_db,
                                         bool(args.get("use_pe", False)))]


def worst(per: list, names) -> dict:
    return {k: max(p[k] for p in per) for k in names}


def check(r, cfg, sr, acc, slice_db, done, keys) -> None:
    """Reference conversions of the sampled songs against the program's
    output files; records the worst of each number the cell's limits
    name."""
    limits = r.workload["check"]["limits"]
    scaled = "gap_over_stated" in limits
    w = weights.make(cfg, r.seed, r.device)
    per = []
    for idx, secs, _ in pick(done, r.seed, int(r.workload["check"]["songs"])):
        _, pcm = wavfile.read(f"raw/{idx}.wav")
        t0 = time.perf_counter()
        refs = reference(w, cfg, r.workload["entry_args"],
                         pcm.astype(np.float32) / 32768.0, sr, keys[idx],
                         acc, noise_seed(r.seed, idx), r.device, slice_db,
                         scaled=scaled)
        _, out = wavfile.read(f"out/{idx}.wav")
        per.append(numbers(out, refs))
        harness.log(f"check song {idx} ({secs:.1f} s, key {keys[idx]}): "
                    f"{per[-1]}, reference {time.perf_counter() - t0:.2f} s")
    got = worst(per, limits) if per else {k: None for k in limits}
    r.checks = [(k, got[k], float(limits[k])) for k in limits]


def control(r: harness.Run) -> dict:
    """The control's numbers on the songs a run of ``r.seed`` would check,
    had its window completed the first ``check.control_songs`` songs: the
    reference one precision lower, in the program's place."""
    wl, mix = r.workload, r.traffic
    gen = harness.load_module("generators", mix["generator"], r.root)
    cfg = port.serving(r.config)
    hp, args = cfg["hparams"], wl["entry_args"]
    sr, acc = int(hp["audio_sample_rate"]), int(args["acc"])
    slice_db = float(args.get("slice_db", -40))
    limits = wl["check"]["limits"]
    songs = gen.songs(mix, r.seed, sr)[: int(wl["check"]["control_songs"])]
    w = weights.make(cfg, r.seed, r.device)
    plans = {i: song for i, _, song in songs}
    per = []
    for idx, secs, _ in pick([(i, s, None) for i, s, _ in songs], r.seed,
                             int(wl["check"]["songs"])):
        pcm, key = gen.render(mix, plans[idx], r.seed, idx, sr, r.device)
        audio = pcm.astype(np.float32) / 32768.0
        ref = dict(w=w, cfg=cfg, args=args, audio=audio, sr=sr, key=key,
                   acc=acc, seed=noise_seed(r.seed, idx), device=r.device,
                   slice_db=slice_db)
        refs = reference(**ref, scaled="gap_over_stated" in limits)
        low = reference(**ref, lowered=True)[0]
        per.append(numbers(low, refs))
        harness.log(f"control song {idx} ({secs:.1f} s, key {key}): "
                    f"{per[-1]}")
    r.attempted = len(per)
    return {"lowered": worst(per, limits)}
