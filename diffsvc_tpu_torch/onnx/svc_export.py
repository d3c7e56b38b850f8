"""The reference's split ONNX artifacts and the vocoder graphs, exported
from the port's modules.

Counterpart of ``diffsvc_tpu/onnx/svc_export.py`` (behaviour target:
reference ``onnx_export.py`` + ``modules/diff/diffusion_V2.py:252-352``,
torch.onnx at opset 16).  The files, graph names, input and output names,
dtypes and dynamic axes are the JAX package's, so the community inference
hosts (VST / MoeSS-style) that load ``{proj}_encoder.onnx`` etc. take
either package's artifacts:

- ``{proj}_encoder.onnx``  (hubert [1, T_ph, H] f32, mel2ph [1, T] i64,
                            spk_embed [1] i64, f0 [1, T] f32)
                           -> mel_pred [1, H, T] (the condition),
                              f0_pred [1, T]
- ``{proj}_denoise.onnx``  (noise [1, 1, M, T] f32, time [1] i64,
                            condition [1, H, T] f32) -> noise_pred
- ``{proj}_pred.onnx``     (noise, noise_pred, time, time_prev) -> the PLMS
                           first-order x_pred (diffusion_V2.py:168-180)
- ``{proj}_after.onnx``    x [1, 1, M, T] -> mel_out [1, M, T]: denorm and
                           log10 -> ln (x 2.30259)
- ``{proj}_dpmpp.onnx`` + ``_dpmpp_meta.json``, ``{proj}_hifigan.onnx``,
  ``{proj}_istft.onnx``: below.

Tracing runs on the CPU by design (as the JAX CLI's "export needs no
accelerator"): the graphs hold each kernel's function, which the plain
versions compute, and a CUDA kernel behind ctypes cannot be traced.  The
exporter asks for the plain routes explicitly (``diffnet.apply(...,
plain=True)``, ``generator.apply``) on a CPU copy of the module; the
caller's module stays where it is, and nothing on the serving path changes.

As in the JAX package, with ``use_spk_id`` the encoder holds the real
speaker-embedding lookup (the reference's exported encoder adds the integer
``spk_embed``).  ``time``, ``time_prev``, ``step``, ``mel2ph`` and
``spk_embed`` are int64 graph inputs, which the port takes natively (JAX
adds a ``Cast`` to its int32 trace).
"""

from __future__ import annotations

import copy
import json
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..models import diffnet
from ..models.diffusion import (DPMPP_NAMES, GaussianDiffusion, denorm_spec,
                                dpmpp_timesteps, make_tables)
from ..vocoders import generator as G
from ..vocoders import istft_head as ih
from .convert import export_onnx, trace


def _on_cpu(module: nn.Module) -> nn.Module:
    """``module`` itself when it is on the CPU, else a CPU copy (the
    caller's module is not moved)."""
    if all(p.device.type == "cpu" for p in module.parameters()):
        return module
    return copy.deepcopy(module).to("cpu")


def _write(path: str, blob: bytes) -> str:
    with open(path, "wb") as f:
        f.write(blob)
    return path


class EncoderGraph(nn.Module):
    def __init__(self, fs2, use_spk: bool):
        super().__init__()
        self.fs2 = fs2
        self.use_spk = use_spk

    def forward(self, hubert, mel2ph, spk_embed, f0):
        ret = self.fs2(hubert, mel2ph, f0,
                       spk_embed=spk_embed if self.use_spk else None)
        return ret["decoder_inp"].transpose(1, 2), ret["f0_denorm"]


class DenoiseGraph(nn.Module):
    def __init__(self, net: diffnet.DiffNet):
        super().__init__()
        self.net = net

    def forward(self, noise, time, condition):
        spec = noise[:, 0].transpose(1, 2)                  # [B, T, M]
        out = diffnet.apply(self.net, spec, time, condition.transpose(1, 2),
                            plain=True)
        return out.transpose(1, 2)[:, None]                 # [B, 1, M, T]


class PredGraph(nn.Module):
    """The PLMS first-order x_pred at integer steps (reference
    diffusion_V2.py:168-180)."""

    def __init__(self, alphas_cumprod: np.ndarray):
        super().__init__()
        self.register_buffer("alphas_cumprod",
                             torch.from_numpy(alphas_cumprod))

    def forward(self, noise, noise_pred, time, time_prev):
        a_t = self.alphas_cumprod[time][:, None, None, None]
        a_prev = self.alphas_cumprod[time_prev][:, None, None, None]
        a_t_sq, a_prev_sq = torch.sqrt(a_t), torch.sqrt(a_prev)
        x_delta = (a_prev - a_t) * (
            (1.0 / (a_t_sq * (a_t_sq + a_prev_sq))) * noise
            - 1.0 / (a_t_sq * (torch.sqrt((1.0 - a_prev) * a_t)
                               + torch.sqrt((1.0 - a_t) * a_prev)))
            * noise_pred)
        return noise + x_delta


class AfterGraph(nn.Module):
    def __init__(self, spec_min, spec_max):
        super().__init__()
        self.register_buffer("spec_min", spec_min.detach().cpu().clone())
        self.register_buffer("spec_max", spec_max.detach().cpu().clone())

    def forward(self, x):
        y = x[:, 0].transpose(1, 2)                         # [B, T, M]
        mel = denorm_spec(y, self.spec_min, self.spec_max) * 2.30259
        return mel.transpose(1, 2)                          # [B, M, T]


def export_svc_onnx(hp, model: GaussianDiffusion, out_dir: str,
                    project_name: str, t_ph: int = 10, t_mel: int = 10,
                    traces: Optional[dict] = None) -> Dict[str, str]:
    """Write the four artifacts of ``model`` (a :class:`GaussianDiffusion`
    with its weights, e.g. from :func:`load_model`); returns {stage: path}.
    ``t_ph``/``t_mel`` are the trace lengths (the time axes are dynamic);
    ``traces``, when given, receives each graph's :class:`Traced` (which
    converts again with other weights, without a new trace)."""
    model = _on_cpu(model)
    if model.decoder_type != "wavenet":
        raise NotImplementedError("the ONNX export covers the wavenet "
                                  "denoiser (diff_decoder_type: wavenet)")
    h, m = int(hp["hidden_size"]), int(model.mel_bins)
    x = torch.zeros(1, 1, m, t_mel)
    step = torch.zeros(1, dtype=torch.long)
    graphs = {
        "encoder": dict(
            module=EncoderGraph(model.fs2, model.fs2.use_spk_id),
            example_args=(torch.zeros(1, t_ph, h),
                          torch.ones(1, t_mel, dtype=torch.long),
                          torch.zeros(1, dtype=torch.long),
                          torch.full((1, t_mel), 6.0)),
            input_names=["hubert", "mel2ph", "spk_embed", "f0"],
            output_names=["mel_pred", "f0_pred"],
            dynamic_axes={"hubert": [1], "mel2ph": [1], "f0": [1]},
            doc=f"diff-svc encoder ({project_name}); "
                "parity: reference modules/encoder.py:101-110"),
        "denoise": dict(
            module=DenoiseGraph(model.denoise_fn),
            example_args=(x, step, torch.zeros(1, h, t_mel)),
            input_names=["noise", "time", "condition"],
            output_names=["noise_pred"],
            dynamic_axes={"noise": [3], "condition": [2]},
            doc=f"diff-svc DiffNet denoiser ({project_name}); "
                "parity: reference modules/diff/net.py DiffNet"),
        "pred": dict(
            module=PredGraph(model.tables_np["alphas_cumprod"]),
            example_args=(x, x, step, step),
            input_names=["noise", "noise_pred", "time", "time_prev"],
            output_names=["noise_pred_o"],
            dynamic_axes={"noise": [3], "noise_pred": [3]},
            doc="PLMS x_pred step; parity: reference "
                "modules/diff/diffusion_V2.py:168-180"),
        "after": dict(
            module=AfterGraph(model.spec_min, model.spec_max),
            example_args=(x,), input_names=["x"], output_names=["mel_out"],
            dynamic_axes={"x": [3]},
            doc="denorm + ln-mel; parity: reference "
                "modules/diff/diffusion_V2.py:153-165"),
    }
    os.makedirs(out_dir, exist_ok=True)
    paths = {}
    for stage, kw in graphs.items():
        tr = trace(kw["module"], kw["example_args"],
                   input_names=kw["input_names"],
                   dynamic_axes=kw["dynamic_axes"])
        paths[stage] = _write(
            os.path.join(out_dir, f"{project_name}_{stage}.onnx"),
            tr.onnx(kw["output_names"], graph_name=stage, doc=kw["doc"]))
        if traces is not None:
            traces[stage] = tr
    return paths


def dpmpp_step_tables(alphas_cumprod: np.ndarray, k_step: int, speedup: int,
                      grid: str = "lambda"):
    """(timesteps [S], tables {name: [S] f32}) of the DPM-Solver++(2M)
    step graph: x0 = noise * inv_a - eps * soa; d = x0 + (x0 - x0_prev) *
    r_half; x_next = c_x * noise + c_d * d.  The first step's r_half is 0
    (the first-order bootstrap); the last has c_x = 0, c_d = 1, so x_next is
    the data prediction at t = 0 (``diffsvc_tpu/onnx/svc_export.py:
    187-214``)."""
    ac = np.asarray(alphas_cumprod, np.float64)
    ts = dpmpp_timesteps(ac, k_step, speedup, grid)
    alpha = np.sqrt(ac)
    sigma = np.sqrt(np.maximum(1.0 - ac, 0.0))
    lam = np.log(alpha) - np.log(np.maximum(sigma, 1e-12))
    s = len(ts)
    c_x, c_d, r_half = np.zeros(s), np.zeros(s), np.zeros(s)
    h_prev = None
    for i in range(s - 1):
        t_c, t_n = int(ts[i]), int(ts[i + 1])
        h = lam[t_n] - lam[t_c]
        c_x[i] = max(sigma[t_n], 1e-12) / max(sigma[t_c], 1e-12)
        c_d[i] = -alpha[t_n] * np.expm1(-h)
        r_half[i] = 0.0 if h_prev is None else 0.5 * h / h_prev
        h_prev = h
    c_x[s - 1], c_d[s - 1] = 0.0, 1.0
    tabs = {"inv_a": 1.0 / np.maximum(alpha[ts], 1e-12),
            "soa": np.maximum(sigma[ts], 1e-12) / np.maximum(alpha[ts], 1e-12),
            "c_x": c_x, "c_d": c_d, "r_half": r_half}
    return ts, {k: v.astype(np.float32) for k, v in tabs.items()}


class DpmppGraph(nn.Module):
    def __init__(self, tables: dict, clip_v: float):
        super().__init__()
        for k, v in tables.items():
            self.register_buffer(k, torch.from_numpy(v))
        self.clip_v = clip_v

    def forward(self, noise, noise_pred, x0_prev, step):
        def at(tab):
            return tab[step][:, None, None, None]

        x0 = noise * at(self.inv_a) - noise_pred * at(self.soa)
        if self.clip_v > 0:     # x0 thresholding, the eps-rewrite folded in
            x0 = torch.clamp(x0, -self.clip_v, self.clip_v)
        d = x0 + (x0 - x0_prev) * at(self.r_half)
        return at(self.c_x) * noise + at(self.c_d) * d, x0


def export_dpmpp_onnx(hp, out_dir: str, project_name: str,
                      speedup: Optional[int] = None,
                      t_mel: int = 10) -> Dict[str, str]:
    """Write ``{proj}_dpmpp.onnx`` + ``{proj}_dpmpp_meta.json``: one
    DPM-Solver++(2M) step of the fast serving profile
    (``configs/config_44k_fast.yaml``), every per-step coefficient baked in
    as a table indexed by the ``step`` input, so the host loop is::

        x0_prev = zeros; ts = meta["timesteps"]        # len S, ts[-1] == 0
        for i in range(S):
            eps = denoise(x, [ts[i]], cond)
            x, x0_prev = dpmpp(x, eps, x0_prev, [i])
        mel = after(x)

    The ladder is the port's :func:`dpmpp_timesteps`, which the in-process
    sampler (``models/diffusion.py``, K2 on the card) visits."""
    tables_np = make_tables(int(hp.get("timesteps", 1000)),
                            hp.get("schedule_type", "cosine"),
                            float(hp.get("max_beta", 0.01)))
    m = int(hp["audio_num_mel_bins"])
    k_step = int(hp.get("K_step", 1000))
    speedup = int(speedup or hp.get("pndm_speedup", 20) or 20)
    grid = str(hp.get("dpmpp_grid", "lambda"))
    clip_v = float(hp.get("sampler_clip_x0", 0) or 0)
    ts, tabs = dpmpp_step_tables(tables_np["alphas_cumprod"], k_step,
                                 speedup, grid)
    x = torch.zeros(1, 1, m, t_mel)
    os.makedirs(out_dir, exist_ok=True)
    path = _write(
        os.path.join(out_dir, f"{project_name}_dpmpp.onnx"), export_onnx(
            DpmppGraph(tabs, clip_v), (x, x, x, torch.zeros(1, dtype=torch.long)),
            input_names=["noise", "noise_pred", "x0_prev", "step"],
            output_names=["x_next", "x0"],
            dynamic_axes={"noise": [3], "noise_pred": [3], "x0_prev": [3]},
            graph_name="dpmpp",
            doc=f"DPM-Solver++(2M) step ({project_name}); in-repo sampler "
                "models/diffusion.py p_sample_dpmpp_2m_scan (not in the "
                "reference export surface)"))
    meta_path = os.path.join(out_dir, f"{project_name}_dpmpp_meta.json")
    with open(meta_path, "w") as f:
        json.dump({"timesteps": [int(t) for t in ts], "K_step": k_step,
                   "speedup": speedup, "grid": grid,
                   "sampler_clip_x0": clip_v}, f)
    return {"dpmpp": path, "dpmpp_meta": meta_path}


class NsfVocoderGraph(nn.Module):
    def __init__(self, gen: G.Generator):
        super().__init__()
        self.gen = gen

    def forward(self, mel, f0, rand_ini, noise):
        return G.apply(self.gen, mel.transpose(1, 2), f0, (rand_ini, noise))


class PlainVocoderGraph(nn.Module):
    def __init__(self, gen: G.Generator):
        super().__init__()
        self.gen = gen

    def forward(self, mel):
        return G.apply_conv_stack(self.gen, mel.transpose(1, 2))


def export_vocoder_onnx(gen: G.Generator, out_dir: str, project_name: str,
                        t_mel: int = 10) -> str:
    """Write ``{proj}_hifigan.onnx``: the (NSF-)HiFi-GAN generator as one
    graph (the reference leaves the vocoder to separately published
    artifacts).  Inputs, with a dynamic T and L = T * prod(upsample_rates):

    - ``mel``  f32 [1, M, T]  natural-log mel (what ``_after`` emits)
    - ``f0``   f32 [1, T]     Hz (NSF configs only)
    - ``rand_ini`` f32 [1, H+1]   U[0, 1) initial harmonic phases
    - ``noise``    f32 [1, H+1, L] N(0, 1) source noise

    The source randomness is a graph input (the artifact is deterministic);
    the generator's plain route (:func:`generator.apply`), whose conv tail
    is K3's plain version, is traced."""
    gen = _on_cpu(gen)
    cfg = gen.cfg
    total_up = int(np.prod(cfg.upsample_rates))
    h, m = cfg.harmonic_num + 1, cfg.num_mels
    if cfg.use_nsf:
        module = NsfVocoderGraph(gen)
        args = (torch.zeros(1, m, t_mel), torch.full((1, t_mel), 220.0),
                torch.zeros(1, h), torch.zeros(1, h, t_mel * total_up))
        input_names = ["mel", "f0", "rand_ini", "noise"]
        dynamic_axes = {"mel": [2], "f0": [1], "noise": [2]}
    else:
        module = PlainVocoderGraph(gen)
        args = (torch.zeros(1, m, t_mel),)
        input_names = ["mel"]
        dynamic_axes = {"mel": [2]}
    os.makedirs(out_dir, exist_ok=True)
    return _write(
        os.path.join(out_dir, f"{project_name}_hifigan.onnx"), export_onnx(
            module, args, input_names=input_names,
            output_names=["waveform"], dynamic_axes=dynamic_axes,
            graph_name="hifigan",
            doc=f"(NSF-)HiFi-GAN generator ({project_name}); total_up="
                f"{total_up} ; parity: reference "
                "modules/nsf_hifigan/models.py:325-396"))


class IstftGraph(nn.Module):
    def __init__(self, head: ih.IstftHead):
        super().__init__()
        self.head = head

    def forward(self, mel, f0=None):
        return ih.apply(self.head, mel, f0)


def export_istft_onnx(head: ih.IstftHead, out_dir: str, project_name: str,
                      t_mel: int = 430) -> str:
    """Write ``{proj}_istft.onnx``: the iSTFT-head vocoder
    (``vocoders/istft_head.py``) as one graph of log10-mel ``mel`` f32
    [1, T, M] (and ``f0`` f32 [1, T] Hz when ``cfg.use_f0``).  Fixed length,
    no dynamic axis: the overlap-add envelope (``ops/istft.py``) is a
    trace-time constant shaped by T, so a graph is exact only at its trace
    length; export one per serving bucket (430: 10 s at 44.1 kHz / 512)."""
    head = _on_cpu(head)
    cfg = head.cfg
    args = (torch.zeros(1, t_mel, cfg.num_mels),)
    input_names = ["mel"]
    if cfg.use_f0:
        args += (torch.full((1, t_mel), 220.0),)
        input_names.append("f0")
    os.makedirs(out_dir, exist_ok=True)
    return _write(
        os.path.join(out_dir, f"{project_name}_istft.onnx"), export_onnx(
            IstftGraph(head), args, input_names=input_names,
            output_names=["waveform"], dynamic_axes=None,
            graph_name="istft_head",
            doc=f"iSTFT-head vocoder ({project_name}), fixed T={t_mel}; "
                "beyond-reference family (vocoders/istft_head.py)"))


def load_model(model_path: str, hp) -> GaussianDiffusion:
    """The :class:`GaussianDiffusion` of a reference-layout checkpoint (a
    ``.ckpt`` or a directory of ``model_ckpt_steps_*.ckpt``), on the CPU."""
    from ..utils import convert

    model = GaussianDiffusion(hp)
    convert.load_reference_state(model, convert.load_ckpt_state_dict(
        model_path))
    return model.eval()


def sampler_is_dpmpp(hp) -> bool:
    return str(hp.get("sampler", "")).lower() in DPMPP_NAMES


class SvcOnnx:
    """The reference's ``SvcOnnx`` facade (reference onnx_export.py:6-17):
    load a project checkpoint, then ``OnnxExport(project_name)``."""

    def __init__(self, project_name: str, config_path: str,
                 hubert_gpu: bool = False,
                 model_path: Optional[str] = None):
        from ..config.hparams import set_hparams

        self.project_name = project_name
        self.hp = set_hparams(config=config_path, exp_name=project_name,
                              infer=True, reset=True, hparams_str="",
                              print_hparams=False)
        self.model = load_model(
            model_path or f"./checkpoints/{project_name}/", self.hp)

    def OnnxExport(self, project_name: Optional[str] = None,
                   out_dir: str = ".") -> Dict[str, str]:
        return export_svc_onnx(self.hp, self.model, out_dir,
                               project_name or self.project_name)
