"""The fused per-bucket conversion program.

Counterpart of ``diffsvc_tpu/infer/fused.py``: the whole post-slicing chain
as one program per length bucket,

    (wav_44k, key_shift, spk, noise) -> (wav_out, f0, mel)

on the device: the resample to 16 kHz for HuBERT (``ops/resample.py``),
the vocoder family's mel (NSF, or the 24 kHz profile's pwg mel), the AC
tracker on its static Praat grid with the mel-grid padding, HuBERT-soft (or
ContentVec) units, the uniform mel2ph alignment
(:func:`align_uniform_device`), ``norm_interp_f0`` on the device
(:func:`norm_interp_f0_device`), the padded condition, the key shift,
sampling through ``GaussianDiffusion.infer`` (K2, with K1 inside; at
``acc <= 1`` DDPM, one K1 call per step) and the vocoder through
``generator.apply_serving`` (K3), fed ln-mel for NSF-HiFiGAN and the
log10-mel as it is for HiFi-GAN (``diffsvc_tpu/infer/fused.py:146-190,
263``), or the iSTFT head (``vocoders/istft_head.apply``, no kernel) on the
NSF mel's geometry and the log10-mel as it is, its backbone in bf16 with
``voc_compute_dtype: bfloat16`` (``:134-147``, ``:272-276``).  Like the
JAX program it runs no pe.  PWG is refused: the JAX program reads the
vocoder's ``params`` and ``cfg`` (``:117``, ``:142``), which its PWG
wrapper lacks, so no fused route runs it.

On the card each (length, batch size, ``use_gt_mel``, ``add_noise_step``,
input wire dtype) is captured once as a CUDA graph, the counterpart of
``jax.jit`` per bucket (:class:`CapturedProgram`); on the CPU the same body
runs eagerly.  The random draws (the sampler's start noise, DDPM's
per-step noise, the NSF source) come from an explicit ``torch.Generator``
outside the program, or from the caller (``init_noise``, ``step_noise``,
``voc_randoms``), and enter as inputs.

``batched_sharded`` splits one batch of chunks across several cards: one
replica of the program per device (its weights copied there once), each
running ``batched`` on its contiguous block of chunks.
"""

from __future__ import annotations

import contextlib
import copy
import math
import time
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops import f0_ac
from ..ops import mel as mel_ops
from ..ops.hopper import diffnet_stack, plms_ladder, vocoder_tail
from ..ops.resample import resample_poly_device
from ..vocoders import generator as gen_mod
from ..vocoders import istft_head

# the kernels' launch counters: (module, counter names)
COUNTERS = ((diffnet_stack, ("launches", "launches_tc", "launches_tf32x3")),
            (plms_ladder, ("launches", "launches_tc", "launches_tf32x3")),
            (vocoder_tail, ("launches",)))


def align_uniform_device(mel_len: int, n_units: int, device=None
                         ) -> torch.Tensor:
    """``features.get_align_uniform`` on the device (reference
    process_pipeline.py:95-107): frame f -> unit j+1 for the first unit j
    whose span ends at or after f.  The ends are computed in float64, as
    the host's Python floats are."""
    i = torch.arange(n_units, dtype=torch.float64, device=device)
    ph_durs = mel_len / n_units
    end_frame = torch.floor(i * ph_durs + ph_durs + 0.5).to(torch.int64)
    f = torch.arange(mel_len, dtype=torch.int64, device=device)
    j = torch.searchsorted(end_frame, f, side="left")
    return torch.clamp(j + 1, 1, n_units)


def norm_f0(f0: torch.Tensor, pitch_norm: str = "log", f0_mean: float = 0.0,
            f0_std: float = 1.0) -> torch.Tensor:
    if pitch_norm == "standard":
        f0 = (f0 - f0_mean) / f0_std
    if pitch_norm == "log":
        f0 = torch.log2(f0)
    return f0


def norm_interp_f0_device(f0: torch.Tensor, pitch_norm: str = "log",
                          f0_mean: float = 0.0, f0_std: float = 1.0):
    """Device ``norm_interp_f0`` over the last axis: normalize, then
    interpolate linearly over unvoiced frames between the nearest voiced
    ones (held flat past the ends).  Returns (f0_interp, uv) float32; a row
    with no voiced frame gives zeros."""
    n = f0.shape[-1]
    voiced = f0 != 0
    lf0 = torch.where(voiced, norm_f0(torch.where(voiced, f0,
                                                  torch.ones_like(f0)),
                                      pitch_norm, f0_mean, f0_std),
                      torch.zeros_like(f0))
    idx = torch.arange(n, device=f0.device)
    # the previous voiced index (or -1) and the next one (or n)
    prev_idx = torch.cummax(torch.where(voiced, idx, -1), dim=-1).values
    next_rev = torch.cummax(torch.where(voiced.flip(-1), idx, -1),
                            dim=-1).values.flip(-1)
    next_idx = n - 1 - next_rev
    has_prev, has_next = prev_idx >= 0, next_idx <= n - 1
    pv = torch.gather(lf0, -1, prev_idx.clamp(0, n - 1))
    nv = torch.gather(lf0, -1, next_idx.clamp(0, n - 1))
    span = torch.clamp((next_idx - prev_idx).to(torch.float32), min=1.0)
    w = (idx - prev_idx).to(torch.float32) / span
    interp = torch.where(has_prev & has_next, pv * (1 - w) + nv * w,
                         torch.where(has_prev, pv, nv))
    out = torch.where(voiced, lf0, interp)
    out = torch.where(voiced.any(dim=-1, keepdim=True), out,
                      torch.zeros_like(out))
    return out.float(), (~voiced).float()


def _counts() -> list:
    return [getattr(mod, k) for mod, names in COUNTERS for k in names]


def _add_counts(delta) -> None:
    it = iter(delta)
    for mod, names in COUNTERS:
        for k in names:
            setattr(mod, k, getattr(mod, k) + next(it))


class CapturedProgram:
    """One bucket's program as a CUDA graph.

    The inputs are copied into static buffers; one warm-up call on a side
    stream (it builds the kernels' plans and packed weights, cuFFT plans,
    the opt-in of shared memory) runs before the capture; a replay
    launches what the capture recorded, and adds the kernel launches the
    capture recorded to the kernels' counters (the capture itself launches
    nothing, so it leaves them as they were).  A failed capture raises.
    """

    def __init__(self, program, inputs):
        t0 = time.perf_counter()
        self.static_in = [x.clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            program(*self.static_in)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.warmup_s = t1 - t0       # host seconds of the warm-up call
        before = _counts()
        # the graph's private pool (the static outputs in it) is what the
        # allocator holds after the capture beyond what it held before, each
        # read with the unused cached blocks released
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.static_out = program(*self.static_in)
        self.capture_s = time.perf_counter() - t1    # of the capture
        after = _counts()
        _add_counts([b - a for a, b in zip(after, before)])
        self.launches = [a - b for a, b in zip(after, before)]
        torch.cuda.empty_cache()
        self.pool_bytes = torch.cuda.memory_reserved() - reserved

    def __call__(self, *inputs):
        for buf, x in zip(self.static_in, inputs):
            buf.copy_(x)
        self.graph.replay()
        _add_counts(self.launches)
        return self.static_out


class FusedSvc:
    """Builds and caches the per-bucket conversion programs of one model."""

    @staticmethod
    def to_float(wav):
        """Decode a fused output waveform: int16 (``fused_output_int16``)
        -> float32 in [-1, 1]; float passes through.  Host-side numpy."""
        w = np.asarray(wav)
        if w.dtype == np.int16:
            return w.astype(np.float32) / 32767.0
        return w

    @staticmethod
    def to_int16(wav):
        """Encode a float waveform to the int16 wire format
        (``fused_input_int16``); int16 passes through.  Inverse of
        :meth:`to_float` on the int16 grid.  Host-side numpy."""
        w = np.asarray(wav)
        if w.dtype == np.int16:
            return w
        return np.round(np.clip(w, -1.0, 1.0) * 32767.0).astype(np.int16)

    def __init__(self, hp, model, vocoder, hubert, speedup: int = 20,
                 compute_dtype: Optional[str] = None,
                 cuda_graphs: bool = True):
        """:param model: a loaded ``GaussianDiffusion``; its weights are
            shared, and the device is theirs
        :param vocoder: the NSF-HiFiGAN, HiFi-GAN or iSTFT-head wrapper
            (``.gen``, ``.cfg``)
        :param hubert: the ``HubertSoft`` (or ``ContentVec``) module
        :param cuda_graphs: capture each bucket on the card (False runs the
            same body eagerly there: the comparison of the two)"""
        # snapshot hp: a later change of the caller's dict (another
        # FusedSvc's compute_dtype, a flag the server sets) must not change
        # what this instance runs
        self.hp = type(hp)(hp)
        if compute_dtype:
            self.hp["diff_compute_dtype"] = compute_dtype
        voc_name = str(self.hp.get("vocoder", "")).lower()
        self.is_nsf = "nsf" in voc_name
        # the iSTFT head is served on the NSF mel's geometry, fed the
        # log10-mel as it is
        self.is_istft = "istft" in voc_name
        if not hasattr(vocoder, "gen"):
            raise ValueError(
                f"the fused program cannot run the {type(vocoder).__name__} "
                "vocoder (the JAX package's fused program reads a "
                "generator's params and cfg, which its PWG wrapper lacks); "
                "convert with Svc.infer or infer_batched")
        if hubert is None:
            raise FileNotFoundError("the fused program needs the HuBERT-soft "
                                    "checkpoint (hubert_path)")
        # the same weights, read with this instance's hp
        self.model = copy.copy(model)
        self.model.hp = self.hp
        self.vocoder = vocoder
        self.hubert = hubert
        if str(self.hp.get("hubert_compute_dtype", "")) in ("bf16",
                                                            "bfloat16"):
            self.hubert = copy.deepcopy(hubert).to(torch.bfloat16)
        self.speedup = int(speedup)
        self.device = next(model.parameters()).device
        self.cuda_graphs = bool(cuda_graphs) and self.device.type == "cuda"
        self._fns = {}
        self.captures = {}   # bucket key -> number of captures
        self._version = None
        self._replicas = {}  # (index, device) -> (weights version, FusedSvc)

    # ------------------------------------------------------------------
    def geometry(self, n44: int) -> dict:
        """Static sizes of the program for ``n44`` input samples."""
        hp = self.hp
        hop, nfft = int(hp["hop_size"]), int(hp["fft_size"])
        if self.is_nsf or self.is_istft:
            t_mel = 1 + (n44 + 2 * ((nfft - hop) // 2) - nfft) // hop
        else:
            t_mel = 1 + n44 // hop
        cfg = self.vocoder.cfg
        up = cfg.hop if self.is_istft else int(np.prod(cfg.upsample_rates))
        return dict(t_mel=t_mel, pad_t=-(-t_mel // 128) * 128,
                    n_voc=t_mel * up)

    def ddpm_steps(self, use_gt_mel: bool = False,
                   add_noise_step: int = 500) -> int:
        """DDPM's steps (the per-step noise's leading size), 0 when the
        program samples with K2's ladder."""
        if self.speedup > 1:
            return 0
        return int(add_noise_step) if use_gt_mel else self.model.K_step

    def _build(self, n44: int, use_gt_mel: bool = False,
               add_noise_step: int = 500):
        hp = self.hp
        sr, hop = int(hp["audio_sample_rate"]), int(hp["hop_size"])
        nmel = int(hp["audio_num_mel_bins"])
        g = self.geometry(n44)
        t_mel, pad_t = g["t_mel"], g["pad_t"]
        f0_min, f0_max = float(hp["f0_min"]), float(hp["f0_max"])
        grid = f0_ac.frame_grid(n44, sr, hop, f0_min)
        n_frames = grid["n_frames"]
        pad_size = (n44 // hop - n_frames + 1) // 2
        src, dst = max(-pad_size, 0), max(pad_size, 0)
        copy_n = min(n_frames - src, t_mel - dst)
        model, hubert, gen = self.model, self.hubert, self.vocoder.gen
        out_int16 = bool(hp.get("fused_output_int16", False))
        f0_ceiling = math.log2(f0_max)
        geo = dict(sr=sr, n_fft=int(hp["fft_size"]), hop=hop,
                   win_length=int(hp["win_size"]), n_mels=nmel,
                   fmin=float(hp["fmin"]), fmax=float(hp["fmax"]))
        voc_scale = mel_ops.LN_10 if self.is_nsf else 1.0
        voc_dtype = torch.bfloat16 if str(hp.get(
            "voc_compute_dtype", "")) in ("bf16", "bfloat16") else None

        @torch.no_grad()
        def program(wav, key_shift, spk, noise, rand_ini, unit_noise,
                    step_noise=None):
            if wav.dtype == torch.int16:
                # as to_float on the host, so both wires agree bit for bit
                wav = wav.float() / 32767.0
            wav16 = resample_poly_device(wav, sr, 16000)
            if self.is_nsf or self.is_istft:
                mel = mel_ops.wav2mel_nsf(wav, **geo)
            else:
                mel = mel_ops.wav2mel_pwg(
                    wav, eps=float(hp.get("wav2spec_eps", 1e-6)), **geo)
            mel = mel[:, :t_mel]
            # the Praat track centred on the mel grid
            f0_track = f0_ac.track(wav, sr=sr, hop=hop, f0_min=f0_min,
                                   f0_max=f0_max)
            f0_grid = F.pad(f0_track[:, src: src + copy_n],
                            (dst, t_mel - dst - copy_n))
            units = hubert.units(wav16.to(next(hubert.parameters()).dtype))
            units = units.float()
            b = wav.shape[0]
            mel2ph = F.pad(align_uniform_device(t_mel, units.shape[1],
                                                wav.device),
                           (0, pad_t - t_mel))[None].expand(b, pad_t)
            f0n, uv = norm_interp_f0_device(
                f0_grid, hp.get("pitch_norm", "log"),
                f0_mean=float(hp.get("f0_mean", 0.0) or 0.0),
                f0_std=float(hp.get("f0_std", 1.0) or 1.0))
            # key shift in log2 with ceiling zeroing (infer_tool.py:149-150)
            f0n = f0n + key_shift[:, None] / 12.0
            f0n = torch.where(f0n > f0_ceiling, torch.zeros_like(f0n), f0n)
            pad = (0, pad_t - t_mel)
            melb = F.pad(mel, (0, 0) + pad)
            # padding frames are log-mel 0 (energy sqrt(n_mels)): masked,
            # as the modular path pads energy with 0
            energy = torch.sqrt((torch.exp(melb) ** 2).sum(-1)) * (
                torch.arange(pad_t, device=wav.device) < t_mel)
            batch = {"hubert": units, "mel2ph": mel2ph,
                     "f0": F.pad(f0n, pad), "uv": F.pad(uv, pad),
                     "energy": energy, "mels": melb}
            if hp.get("use_spk_id"):
                batch["spk_embed"] = spk
            out = model.infer(batch, speedup=self.speedup,
                              use_gt_mel=use_gt_mel,
                              add_noise_step=add_noise_step,
                              init_noise=noise, step_noise=step_noise)
            mel_pred = torch.clamp(out["mel_out"][:, :t_mel],
                                   float(hp.get("mel_vmin", -6.0)),
                                   float(hp.get("mel_vmax", 1.5)))
            # the vocoder's f0 is the conditioner's (key-shifted) one, as the
            # reference's use_pe=False path
            f0_voc = out["f0_denorm"][:, :t_mel]
            if self.is_istft:
                wav_out = istft_head.apply(
                    gen, mel_pred, f0_voc if gen.cfg.use_f0 else None,
                    dtype=voc_dtype)
            else:
                wav_out = gen_mod.apply_serving(gen, mel_pred * voc_scale,
                                                f0_voc, (rand_ini, unit_noise))
            if out_int16:
                wav_out = torch.round(torch.clamp(wav_out, -1.0, 1.0)
                                      * 32767.0).to(torch.int16)
            return wav_out, f0_voc, mel_pred

        return program

    def _weights_version(self) -> tuple:
        return tuple(p._version for m in (self.model, self.vocoder.gen,
                                          self.hubert)
                     for p in m.parameters())

    def _get_fn(self, n44: int, batch: int, use_gt_mel: bool,
                add_noise_step: int, inputs):
        # a captured graph reads the weights (and their packed forms) it
        # was captured with: after any in-place change of a weight, every
        # bucket is built again, as JAX's programs take the params as
        # arguments
        version = self._weights_version()
        if version != self._version:
            self._fns.clear()
            self._version = version
        key = (n44, batch, bool(use_gt_mel),
               int(add_noise_step) if use_gt_mel else None, inputs[0].dtype)
        if key not in self._fns:
            program = self._build(n44, use_gt_mel, add_noise_step)
            if self.cuda_graphs:
                program = CapturedProgram(program, inputs)
                self.captures[key] = self.captures.get(key, 0) + 1
            self._fns[key] = program
        return self._fns[key]

    def _draws(self, b: int, n44: int, generator, init_noise, voc_randoms,
               step_noise=None, n_steps: int = 0):
        """(start noise, the NSF source's two draws[, DDPM's per-step
        noise when ``n_steps``]) on the device: the caller's, else drawn
        from ``generator``, in that order."""
        g = self.geometry(n44)
        dev = self.device
        if generator is None and (init_noise is None or voc_randoms is None
                                  or (n_steps and step_noise is None)):
            generator = torch.Generator(device=dev).manual_seed(0)
        if init_noise is None:
            init_noise = torch.randn((b, g["pad_t"], self.model.mel_bins),
                                     generator=generator, device=dev)
        if voc_randoms is None and self.is_istft:
            # the iSTFT head draws nothing: empty stand-ins keep the
            # program's inputs
            voc_randoms = (torch.zeros((b, 0), device=dev),
                           torch.zeros((b, 0, 0), device=dev))
        elif voc_randoms is None:
            voc_randoms = gen_mod.draw_randoms(
                b, g["n_voc"], self.vocoder.cfg.harmonic_num, generator, dev)
        draws = [init_noise, *voc_randoms]
        if n_steps:
            if step_noise is None:
                step_noise = torch.randn(
                    (n_steps, b, g["pad_t"], self.model.mel_bins),
                    generator=generator, device=dev)
            draws.append(step_noise)
        return tuple((r if isinstance(r, torch.Tensor) else torch.from_numpy(
            np.array(r, np.float32))).to(dev, torch.float32) for r in draws)

    def run(self, stacked: np.ndarray, key_shifts, spk_id: int = 0,
            generator: Optional[torch.Generator] = None,
            use_gt_mel: bool = False, add_noise_step: int = 500,
            init_noise=None, voc_randoms=None, step_noise=None):
        """The program for ``stacked`` [B, n44] (int16 or float32) as it is,
        no padding or trimming.  ``init_noise`` [B, pad_t, M],
        ``voc_randoms`` (``generator.draw_randoms`` at B and the vocoder's
        length) and, at ``acc <= 1``, ``step_noise`` [``ddpm_steps``, B,
        pad_t, M] replace the draws from ``generator``.  Returns the device
        tensors (wav [B, n_voc], f0 [B, t_mel], mel [B, t_mel, M]); on the
        card they are the graph's static outputs, valid until its next
        replay."""
        b, n44 = stacked.shape
        dev = self.device
        inputs = (torch.from_numpy(np.ascontiguousarray(stacked)).to(dev),
                  torch.as_tensor(np.asarray(key_shifts, np.float32)
                                  ).reshape(b).to(dev),
                  torch.full((b,), int(spk_id), dtype=torch.long, device=dev),
                  *self._draws(b, n44, generator, init_noise, voc_randoms,
                               step_noise, self.ddpm_steps(use_gt_mel,
                                                           add_noise_step)))
        fn = self._get_fn(n44, b, use_gt_mel, add_noise_step, inputs)
        return fn(*inputs)

    def _wire(self, wav) -> np.ndarray:
        w = np.asarray(wav)
        if w.dtype != np.int16:
            w = w.astype(np.float32, copy=False)
            if bool(self.hp.get("fused_input_int16", False)):
                w = self.to_int16(w)
        return w

    def _padded_length(self, n: int) -> int:
        bucket = int(self.hp.get("fused_bucket_samples", 0) or 0)
        return -(-n // bucket) * bucket if bucket else n

    def __call__(self, wav44, generator: Optional[torch.Generator] = None,
                 key_shift: float = 0, spk_id: int = 0,
                 use_gt_mel: bool = False, add_noise_step: int = 500,
                 init_noise=None, voc_randoms=None, step_noise=None):
        """Convert one chunk: (wav, f0, mel) as host numpy, trimmed to the
        input's length (``fused_bucket_samples`` pads it up to a bucket
        multiple first).  The wav is int16 with ``fused_output_int16``
        (decode with :meth:`to_float`)."""
        wav44 = self._wire(wav44)
        true_n = len(wav44)
        n44 = self._padded_length(true_n)
        stacked = np.zeros((1, n44), wav44.dtype)
        stacked[0, :true_n] = wav44
        wav_o, f0_o, mel_o = self.run(
            stacked, [key_shift], spk_id, generator, use_gt_mel,
            add_noise_step, init_noise, voc_randoms, step_noise)
        t_true = -(-true_n // int(self.hp["hop_size"]))
        return (wav_o[0, :true_n].cpu().numpy(), f0_o[0, :t_true].cpu().numpy(),
                mel_o[0, :t_true].cpu().numpy())

    def _stack(self, wavs, rows: int, key_shifts):
        """N chunks as ``rows`` >= N rows of one bucket, silent rows after
        the chunks (the wire int16 through the hp flag or when every input
        is int16: float members of a mixed batch are never quantized), and
        the key shifts as one float per row (a scalar or one per chunk;
        the silent rows 0)."""
        n44 = self._padded_length(max(len(w) for w in wavs))
        int16_wire = (bool(self.hp.get("fused_input_int16", False))
                      or all(np.asarray(w).dtype == np.int16 for w in wavs))
        stacked = np.zeros((rows, n44), np.int16 if int16_wire
                           else np.float32)
        for i, w in enumerate(wavs):
            stacked[i, : len(w)] = self.to_int16(w) if int16_wire \
                else self.to_float(w)
        ks = np.zeros((rows,), np.float32)
        ks[:len(wavs)] = 0 if key_shifts is None else key_shifts
        return stacked, ks

    def _trim(self, outs, wavs) -> list:
        """(wav, f0, mel) per chunk from the host outputs [rows, ...]."""
        hop = int(self.hp["hop_size"])
        wav_o, f0_o, mel_o = outs
        return [(wav_o[i, :len(w)], f0_o[i, : -(-len(w) // hop)],
                 mel_o[i, : -(-len(w) // hop)]) for i, w in enumerate(wavs)]

    def batched(self, wavs, generator: Optional[torch.Generator] = None,
                key_shifts=None, spk_id: int = 0, init_noise=None,
                voc_randoms=None, step_noise=None):
        """Convert N chunks in one program at B = N (K2 and K3 at B = N):
        each padded to the longest (rounded up to ``fused_bucket_samples``)
        and trimmed back.  ``key_shifts``: a scalar or one per chunk.
        Returns a list of (wav, f0, mel) per chunk."""
        if len(wavs) < 1:
            raise ValueError("batched: no chunks")
        stacked, ks = self._stack(wavs, len(wavs), key_shifts)
        return self._trim([t.cpu().numpy() for t in self.run(
            stacked, ks, spk_id, generator, init_noise=init_noise,
            voc_randoms=voc_randoms, step_noise=step_noise)], wavs)

    def replica(self, i: int, device) -> "FusedSvc":
        """The program's replica for entry ``i`` of a device list: this
        instance for entry 0 on its own device, otherwise a copy of the
        weights on ``device`` made once (again after a weight of this
        instance changes in place), with its own buckets."""
        device = torch.device(device)
        if i == 0 and device == self.device:
            return self
        version = self._weights_version()
        hit = self._replicas.get((i, device))
        if hit is None or hit[0] != version:
            voc = copy.copy(self.vocoder)
            voc.gen = copy.deepcopy(self.vocoder.gen).to(device)
            rep = FusedSvc(self.hp, copy.deepcopy(self.model).to(device), voc,
                           copy.deepcopy(self.hubert).to(device),
                           speedup=self.speedup,
                           cuda_graphs=self.cuda_graphs)
            hit = self._replicas[(i, device)] = (version, rep)
        return hit[1]

    def batched_sharded(self, wavs, devices, generator=None, key_shifts=None,
                        spk_id: int = 0, init_noise=None, voc_randoms=None):
        """Data-sharded batched serving, the single-controller counterpart
        of ``diffsvc_tpu/infer/fused.py:452-502``: N chunks padded to a
        multiple of ``len(devices)`` with silent dummy chunks (their results
        dropped), the contiguous block ``[r N'/D, (r+1) N'/D)`` of chunks
        through :meth:`batched`'s program on the replica of ``devices[r]``
        (:meth:`replica`), all at the bucket of the longest chunk.  Every
        replica is issued before any result is read back, so replicas on
        different cards overlap.

        The draws are :meth:`batched`'s for the N real chunks (``init_noise``
        [N, pad_t, M] and ``voc_randoms`` at N, else drawn from
        ``generator`` in its order), so a chunk's result is ``batched``'s
        whatever the number of devices; the dummies get zeros.  Returns a
        list of (wav, f0, mel) per real chunk."""
        n, d = len(wavs), len(devices)
        if n < 1 or d < 1:
            raise ValueError("batched_sharded: no chunks or no devices")
        n_pad = -(-n // d) * d
        stacked, ks = self._stack(wavs, n_pad, key_shifts)
        draws = [F.pad(r, (0, 0) * (r.dim() - 1) + (0, n_pad - n))
                 for r in self._draws(n, stacked.shape[1], generator,
                                      init_noise, voc_randoms)]
        k = n_pad // d
        outs = []
        for r, dev in enumerate(devices):
            rep = self.replica(r, dev)
            rows = slice(r * k, (r + 1) * k)
            with torch.cuda.device(rep.device) if rep.device.type == "cuda" \
                    else contextlib.nullcontext():
                # each replica replays its own graph, so these outputs are
                # not overwritten before they are read back below
                outs.append(rep.run(stacked[rows], ks[rows], spk_id,
                                    init_noise=draws[0][rows].to(rep.device),
                                    voc_randoms=tuple(x[rows].to(rep.device)
                                                      for x in draws[1:])))
        return self._trim([torch.cat([o[j].cpu() for o in outs]).numpy()
                           for j in range(3)], wavs)

    def pool_bytes(self) -> dict:
        """Graph memory per captured bucket (the private pools' reserve)."""
        return {k: fn.pool_bytes for k, fn in self._fns.items()
                if isinstance(fn, CapturedProgram)}

    def capture_seconds(self) -> dict:
        """(warm-up, capture) host seconds per captured bucket."""
        return {k: (fn.warmup_s, fn.capture_s) for k, fn in self._fns.items()
                if isinstance(fn, CapturedProgram)}

