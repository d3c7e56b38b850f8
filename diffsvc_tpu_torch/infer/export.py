"""Compiled-program export: the serving chain as ``torch.export`` programs.

Counterpart of ``diffsvc_tpu/infer/export.py``, which writes each stage as
a serialized StableHLO artifact through ``jax.export``.  Here each stage is
a ``.pt2`` file (``torch.export.save``), reloaded with
``torch.export.load`` (:func:`load_exported`):

- ``encoder``:  (hubert, mel2ph, f0, uv, energy) -> (decoder_inp, f0_denorm)
- ``denoiser``: (x_t, t, cond) -> noise prediction (K1)
- ``sampler``:  (cond, noise) -> denormed mel, the whole trajectory at a
  fixed speedup (K2, with K1 inside)
- ``vocoder``:  (mel, f0) -> waveform (K3), its NSF draws fixed inside
- ``fused_{n44}``: one length bucket of :class:`~.fused.FusedSvc`'s
  program, raw wav in, converted wav out (:func:`export_fused`)

Shapes are fixed per export (bucketed lengths), as JAX's.  Two things
differ from JAX on purpose:

- The kernels are in the programs.  K1, K2 and K3 are registered ops
  (``diffsvc_tpu_torch::residual_stack``, ``plms_ladder``,
  ``vocoder_tail``, in ``ops/hopper``) and the programs call them: a
  program exported on the card launches the hand-written kernels, one
  exported on the CPU runs their plain versions.  JAX's ``export_fused``
  forces XLA instead, since ``jax.export`` rejects Mosaic custom calls.  A
  consumer imports the port's op library (``diffsvc_tpu_torch.ops.hopper``)
  and nothing else of the port, as a JAX consumer imports ``jax``.
- The fused program's random draws are inputs (the sampler's start noise
  and the NSF source, as :meth:`FusedSvc.run` takes them), where JAX's
  takes a ``uint32[2]`` key; ``fused_meta.json`` records their shapes.

A program runs on the device it was exported on (``device`` in the meta),
with the weights it read baked in as constants: the exported function
holds the port's modules as plain attributes, so the trace lifts exactly
the tensors it reads, the serving routes' kept forms among them
(``DiffNet.stacked``, ``Generator.tail_plan``'s packed convs, the ladder's
tables).  Those are built by one eager call of the function before the
trace, which the trace then reads back.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..ops.hopper import load_program
from .svc import default_device

STAGE_SUFFIX = ".pt2"


class _Program(nn.Module):
    """``fn`` as a module for ``torch.export``: the modules it reads are
    not submodules, so the program's state is what ``fn`` reads."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


def export_program(fn, args) -> torch.export.ExportedProgram:
    """Run ``fn(*args)`` once, then export it.  The eager call fills every
    cache the function reads with real tensors (a trace that missed one
    would compute it in the program, or keep a traced tensor in the
    cache); on the card it also builds the kernels.  The example inputs
    are cloned: the trace reads one tensor passed as two inputs as one of
    them alone."""
    args = tuple(a.clone() for a in args)
    with torch.no_grad():
        fn(*args)
        return torch.export.export(_Program(fn), args)


def _export_fn(fn, args, path: str) -> str:
    torch.export.save(export_program(fn, args), path)
    return path


# operators that compute a convolution or a matrix product
PRODUCTS = ("convolution", "conv1d", "conv2d", "conv_transpose1d", "matmul",
            "mm", "bmm", "addmm", "linear", "einsum")


def program_ops(program) -> dict:
    """What a program (an ``ExportedProgram`` or a saved ``.pt2``) calls:
    ``ops``, the count of each kernel op (``diffsvc_tpu_torch::*``);
    ``products``, the number of convolution and matrix-product nodes;
    ``shared``, the tensors a kernel op reads that another node reads too
    (none: the kernels' weights are read by the kernels alone, so no plain
    route over them is in the program)."""
    if isinstance(program, str):
        program = torch.export.load(program)
    ops, users, products = {}, {}, 0
    for node in program.graph.nodes:
        if node.op != "call_function":
            continue
        # "diffsvc_tpu_torch.residual_stack.default", "aten.conv1d.default"
        namespace, _, rest = str(node.target).partition(".")
        op = rest.split(".")[0]
        kernel = namespace == "diffsvc_tpu_torch"
        if kernel:
            ops[op] = ops.get(op, 0) + 1
        elif namespace == "aten" and op in PRODUCTS:
            products += 1
        for arg in node.all_input_nodes:
            if arg.op == "placeholder":
                users.setdefault(arg.name, set()).add(kernel)
    return {"ops": ops, "products": products,
            "shared": sorted(k for k, v in users.items() if v == {True, False})}


def load_exported(path: str):
    """A program written here, loaded: its callable (the op library is
    imported with this module)."""
    return load_program(path)


def _dtype_name(dt: torch.dtype) -> str:
    return str(dt).replace("torch.", "")


class SvcExporter:
    """Writes the per-stage programs of a loaded ``GaussianDiffusion`` (and
    optionally its NSF-HiFiGAN or HiFi-GAN V1 vocoder wrapper, ``.gen``).
    The modules are moved to ``device`` (default: the card; raises without
    one), where the programs run."""

    def __init__(self, hp, model, vocoder=None, device=None):
        from ..vocoders.generator import Generator

        if model.decoder_type != "wavenet":
            raise ValueError("the program export takes the wavenet denoiser "
                             "(K1 and K2); the FFT denoiser has no sampler "
                             "program")
        self.device = default_device(device)
        self.hp = hp
        self.model = model.to(self.device)
        self.vocoder = vocoder
        if vocoder is not None:
            if not isinstance(getattr(vocoder, "gen", None), Generator):
                raise ValueError(f"the vocoder program takes NSF-HiFiGAN or "
                                 f"HiFi-GAN V1 (a generator), not "
                                 f"{type(vocoder).__name__}")
            vocoder.gen.to(self.device)

    def stages(self, t_mel: int = 1024, t_ph: int = 512, batch: int = 1,
               speedup: Optional[int] = None) -> Dict[str, tuple]:
        """Each stage's function and example inputs, ``{name: (fn,
        args)}``, as :meth:`export` writes them (``speedup``: the config's
        ``pndm_speedup`` when None)."""
        from ..models import diffnet
        from ..models.diffusion import DPMPP_NAMES, compute_dtype, denorm_spec
        from ..vocoders import generator as gen_mod

        hp, model, dev = self.hp, self.model, self.device
        h = int(hp["hidden_size"])
        m = int(hp["audio_num_mel_bins"])
        speedup = self.speedup(speedup)
        dt = compute_dtype(hp)
        sampler = str(hp.get("sampler", "plms")).lower()
        clip_v = float(hp.get("sampler_clip_x0", 0) or 0)
        net = model.denoise_fn

        def zeros(*shape, dtype=torch.float32):
            return torch.zeros(shape, dtype=dtype, device=dev)

        def encoder_fn(hubert, mel2ph, f0, uv, energy):
            ret = model.fs2(hubert, mel2ph, f0, uv, energy)
            return ret["decoder_inp"], ret["f0_denorm"]

        def denoiser_fn(x, t, cond):
            return diffnet.apply(net, x.to(dt), t, cond).float()

        def sampler_fn(cond, noise):
            x = model._ladder(cond, noise, model.K_step, speedup, clip_v,
                              "dpmpp" if sampler in DPMPP_NAMES else "plms")
            return denorm_spec(x, model.spec_min, model.spec_max)

        frames = [zeros(batch, t_mel) for _ in range(3)]
        out = {
            "encoder": (encoder_fn, (
                zeros(batch, t_ph, h),
                torch.ones((batch, t_mel), dtype=torch.long, device=dev),
                *frames)),
            "denoiser": (denoiser_fn, (zeros(batch, t_mel, m),
                                       zeros(batch, dtype=torch.long),
                                       zeros(batch, t_mel, h))),
            "sampler": (sampler_fn, (zeros(batch, t_mel, h),
                                     zeros(batch, t_mel, m))),
        }
        if self.vocoder is not None:
            gen = self.vocoder.gen
            # the NSF source's draws, fixed inside the program as JAX fixes
            # them with PRNGKey(0): the port's own draw from seed 0
            randoms = None
            if gen.cfg.use_nsf:
                randoms = tuple(r.to(dev) for r in gen_mod.draw_randoms(
                    batch, t_mel * int(np.prod(gen.cfg.upsample_rates)),
                    gen.cfg.harmonic_num, torch.Generator().manual_seed(0)))

            def vocoder_fn(mel, f0):
                return gen_mod.apply_serving(gen, mel, f0, randoms)

            out["vocoder"] = (vocoder_fn, (zeros(batch, t_mel, m),
                                           zeros(batch, t_mel)))
        return out

    def speedup(self, speedup: Optional[int] = None) -> int:
        return int(speedup or self.hp.get("pndm_speedup", 10) or 10)

    def export(self, out_dir: str, t_mel: int = 1024, t_ph: int = 512,
               batch: int = 1, speedup: Optional[int] = None
               ) -> Dict[str, str]:
        """Write every stage (``{name}.pt2``) and ``export_meta.json``;
        returns the stages' paths."""
        from ..models.diffusion import compute_dtype

        os.makedirs(out_dir, exist_ok=True)
        paths = {name: _export_fn(fn, args, os.path.join(
                     out_dir, name + STAGE_SUFFIX))
                 for name, (fn, args) in self.stages(
                     t_mel, t_ph, batch, speedup).items()}
        hp = self.hp
        meta = {"t_mel": t_mel, "t_ph": t_ph, "batch": batch,
                "speedup": self.speedup(speedup),
                "mel_bins": int(hp["audio_num_mel_bins"]),
                "hidden": int(hp["hidden_size"]),
                "sample_rate": int(hp["audio_sample_rate"]),
                "device": self.device.type,
                "dtype": _dtype_name(compute_dtype(hp))}
        with open(os.path.join(out_dir, "export_meta.json"), "w") as f:
            json.dump(meta, f, indent=2)
        return paths


def fused_draws(fused_svc, n44: int) -> list:
    """The fused program's draw inputs at one bucket, in order: (name,
    shape, distribution) of the sampler's start noise, the NSF source's
    rand_ini and unit_noise (empty for the iSTFT head) and, at ``acc <=
    1``, DDPM's per-step noise (:meth:`FusedSvc._draws`'s order)."""
    g = fused_svc.geometry(int(n44))
    m = fused_svc.model.mel_bins
    h = 0 if fused_svc.is_istft else fused_svc.vocoder.cfg.harmonic_num + 1
    n_voc = 0 if fused_svc.is_istft else g["n_voc"]
    draws = [("noise", [1, g["pad_t"], m], "normal"),
             ("rand_ini", [1, h], "uniform"),
             ("unit_noise", [1, h, n_voc], "normal")]
    steps = fused_svc.ddpm_steps()
    if steps:
        draws.append(("step_noise", [steps, 1, g["pad_t"], m], "normal"))
    return draws


def export_fused(fused_svc, out_dir: str, n44: int) -> str:
    """Export the fused program of one length bucket, weights baked in:

        (wav44 [n44] f32, key_shift [] f32, spk [] int64, *draws)
            -> (wav_out [n_voc], f0 [t_mel], mel [t_mel, M])

    with the draws of :func:`fused_draws`, on the FusedSvc's device.
    Consumption: ``python -m diffsvc_tpu_torch.run_exported --fused`` or
    :func:`load_exported`; on the same inputs it equals ``FusedSvc.run``.
    Writes ``fused_{n44}.pt2`` and merges the bucket into
    ``fused_meta.json``."""
    from ..models.diffusion import compute_dtype

    os.makedirs(out_dir, exist_ok=True)
    n44 = int(n44)
    program = fused_svc._build(n44)
    dev = fused_svc.device

    def fused_fn(wav44, key_shift, spk, *draws):
        wav, f0, mel = program(wav44[None], key_shift.reshape(1),
                               spk.reshape(1), *draws)
        return wav[0], f0[0], mel[0]

    draws = fused_draws(fused_svc, n44)
    args = (torch.zeros((n44,), device=dev), torch.zeros((), device=dev),
            torch.zeros((), dtype=torch.long, device=dev),
            *(torch.zeros(shape, device=dev) for _, shape, _ in draws))
    path = _export_fn(fused_fn, args,
                      os.path.join(out_dir, f"fused_{n44}{STAGE_SUFFIX}"))
    meta_path = os.path.join(out_dir, "fused_meta.json")
    meta = {}
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            meta = json.load(f)
    meta[str(n44)] = {
        "sample_rate": int(fused_svc.hp["audio_sample_rate"]),
        "hop_size": int(fused_svc.hp["hop_size"]),
        "speedup": fused_svc.speedup,
        "device": dev.type,
        "dtype": _dtype_name(compute_dtype(fused_svc.hp)),
        "draws": [{"name": n, "shape": s, "dist": d} for n, s, d in draws],
    }
    with open(meta_path, "w") as f:
        json.dump(meta, f, indent=2)
    return path
