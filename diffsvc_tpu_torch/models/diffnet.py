"""DiffNet — the non-causal WaveNet denoiser.

Counterpart of ``diffsvc_tpu/models/diffnet.py`` (reference
``network/diff/net.py:58-135``): 1x1 input projection -> ReLU -> L gated
residual blocks (dilated conv k=3, dilation 2^(i % cycle), diffusion-step
add, 1x1 conditioner add) -> skip-sum/sqrt(L) -> 1x1 -> ReLU -> 1x1.

The module keeps the reference parameter names
(``residual_layers.{i}.dilated_conv.weight`` ...), so reference state dicts
load with ``load_state_dict``.  The math runs on layer-stacked weights in the
JAX package's layouts (:meth:`DiffNet.stacked` for serving, cached and
detached; :meth:`DiffNet.weights` for training, rebuilt with grad on every
call).  The residual stack goes through K1 (``ops/hopper/diffnet_stack.py``)
when serving; when :func:`apply` is given a ``train_stream`` it takes the
route :func:`train_route` picks, as the JAX package does: K4
(``ops/hopper/diffnet_stack_train.py``) or K5
(``ops/hopper/diffnet_stack_per_sample.py``).  The kernels run for CUDA
tensors, their plain versions for CPU tensors.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.hopper import (diffnet_stack, diffnet_stack_per_sample,
                          diffnet_stack_train)
from . import nn as fnn

_MIB = 2 ** 20


def train_route(n_layers: int, cycle: int, t: int, c: int, b: int,
                stream: str = "bf16", seq: int = 1,
                pallas: str = "auto") -> str:
    """The training route of ``diffsvc_tpu/models/diffnet.py:219-295`` for
    a batch of ``b`` samples of ``t`` frames: the port's own copy of the
    shape arithmetic of ``supported_train_batched`` and ``supported_train``
    (``diffsvc_tpu/ops/pallas/diffnet_stack.py:663-686``, ``:426-439``).

    It is carried over as a route rule, not as a check of this card's
    memory: the route decides the numbers.  "batched" is K4 at the
    configured ``stream`` (bf16 or f32) with weight grads summed over the
    whole batch; "per_sample" is K5 with f32 streams and per-sample sums;
    "scan" is the JAX package's f32 XLA scan, which the port computes
    with K4 at the f32 stream (the scan's math in exact f32).  Under a
    grid with a seq axis of ``seq`` > 1 every batch takes the scan,
    whatever its shape and stream: JAX's ``_shardable_data_mesh``
    (``diffnet.py:123-135``) refuses such a mesh, so ``want`` is False
    (``:230-235``).  ``pallas`` is ``diffnet_pallas_train``: "off" takes
    the scan for every batch and stream, as JAX trains through its f32
    scan then (``diffnet.py:219-220``); "auto", "on" and "interpret" leave
    the choice to the shape."""
    if seq > 1 or pallas == "off":
        return "scan"
    if not (c % 128 == 0 and t % 128 == 0 and cycle >= 1
            and n_layers % cycle == 0 and 2 ** (cycle - 1) < t):
        return "scan"
    e = 2 if stream == "bf16" else 4
    streams = 2 * (t * c * e + t * 2 * c * e + 3 * c * 2 * c * e
                   + c * 2 * c * e + t * c * e + t * 2 * c * e + t * c * 4)
    accum = (3 * c * 2 * c + c * 2 * c + 4 * 2 * c) * 4
    if b >= 1 and streams + accum + b * t * c * 4 <= 60 * _MIB:
        return "batched"
    streamed = 2 * (t * 2 * c + 3 * c * 2 * c + c * 2 * c) * 4
    resident = 8 * t * c * 4 + 2 * t * 2 * c * 4
    return "per_sample" if streamed + resident <= 64 * _MIB else "scan"


class ResidualBlock(nn.Module):
    def __init__(self, encoder_hidden: int, residual_channels: int,
                 dilation: int):
        super().__init__()
        c = residual_channels
        self.dilated_conv = nn.Conv1d(c, 2 * c, 3, padding=dilation,
                                      dilation=dilation)
        self.diffusion_projection = nn.Linear(c, c)
        self.conditioner_projection = nn.Conv1d(encoder_hidden, 2 * c, 1)
        self.output_projection = nn.Conv1d(c, 2 * c, 1)


class DiffNet(nn.Module):
    def __init__(self, in_dims: int = 80, encoder_hidden: int = 256,
                 residual_layers: int = 20, residual_channels: int = 256,
                 dilation_cycle_length: int = 4):
        super().__init__()
        if residual_layers % dilation_cycle_length:
            raise ValueError("residual_layers must be a multiple of "
                             "dilation_cycle_length")
        c = residual_channels
        self.in_dims = in_dims
        self.residual_channels = c
        self.n_layers = residual_layers
        self.cycle = dilation_cycle_length
        self.input_projection = nn.Conv1d(in_dims, c, 1)
        self.mlp = nn.Sequential(nn.Linear(c, c * 4), nn.Mish(),
                                 nn.Linear(c * 4, c))
        self.residual_layers = nn.ModuleList([
            ResidualBlock(encoder_hidden, c, 2 ** (i % dilation_cycle_length))
            for i in range(residual_layers)])
        self.skip_projection = nn.Conv1d(c, c, 1)
        self.output_projection = nn.Conv1d(c, in_dims, 1)
        self._stacked = {}
        self.init_weights()

    @torch.no_grad()
    def init_weights(self) -> None:
        """The JAX package's init (``diffsvc_tpu/models/diffnet.py:53-79``,
        the reference's ``net.py``): kaiming-normal convolution weights
        (fan_in, gain sqrt 2) with torch's default uniform biases,
        torch-default linears, and a zero output projection, so a fresh
        model predicts zero noise and its first l2 loss is ~1."""
        for m in self.modules():
            if isinstance(m, nn.Conv1d):
                nn.init.kaiming_normal_(m.weight)
        nn.init.zeros_(self.output_projection.weight)
        nn.init.zeros_(self.output_projection.bias)

    @classmethod
    def from_hparams(cls, hp) -> "DiffNet":
        """The config's DiffNet.  ``use_remat`` (JAX: ``jax.checkpoint``
        around each dilation cycle of its f32 scan, ``diffnet.py:321-324``)
        changes no number and no route here: the backward of every port
        route (K4, K5 and their plain versions' hand-written backwards)
        already saves only each layer's input x_l and recomputes the gates
        from it.  It saves L such [B, T, C] inputs (20 at config_44k)
        where JAX's remat scan keeps the L / cycle cycle boundaries (5)."""
        return cls(in_dims=hp["audio_num_mel_bins"],
                   encoder_hidden=hp["hidden_size"],
                   residual_layers=hp["residual_layers"],
                   residual_channels=hp["residual_channels"],
                   dilation_cycle_length=hp["dilation_cycle_length"])

    def weights(self, dtype: torch.dtype = torch.float32) -> dict:
        """Weights in the JAX package's layouts, cast to ``dtype`` and
        stacked over layers: win [M,C], wd [L,3,C,2C], wc [L,H,2C],
        wo [L,C,2C], dp_w [L,C,C] (in, out), wskip [C,C], wout [C,M], the
        step MLP in torch Linear layout.  Built anew from the parameters on
        every call, so gradients flow back to them (the training route)."""
        rl = self.residual_layers

        def st(get):
            return torch.stack([get(layer) for layer in rl])

        p = {
            "win": self.input_projection.weight[:, :, 0].t(),
            "bin": self.input_projection.bias,
            "w1": self.mlp[0].weight, "b1": self.mlp[0].bias,
            "w2": self.mlp[2].weight, "b2": self.mlp[2].bias,
            "dp_w": st(lambda m: m.diffusion_projection.weight.t()),
            "dp_b": st(lambda m: m.diffusion_projection.bias),
            "wd": st(lambda m: m.dilated_conv.weight.permute(2, 1, 0)),
            "bd": st(lambda m: m.dilated_conv.bias),
            "wc": st(lambda m: m.conditioner_projection.weight[:, :, 0].t()),
            "bc": st(lambda m: m.conditioner_projection.bias),
            "wo": st(lambda m: m.output_projection.weight[:, :, 0].t()),
            "bo": st(lambda m: m.output_projection.bias),
            "wskip": self.skip_projection.weight[:, :, 0].t(),
            "bskip": self.skip_projection.bias,
            "wout": self.output_projection.weight[:, :, 0].t(),
            "bout": self.output_projection.bias,
        }
        return {k: v.to(dtype) for k, v in p.items()}

    @torch.no_grad()
    def stacked(self, dtype: torch.dtype = torch.float32) -> dict:
        """:meth:`weights` detached and contiguous, for serving: cached
        until a weight changes."""
        version = tuple(p._version for p in self.parameters())
        key = (dtype, self.input_projection.weight.device)
        hit = self._stacked.get(key)
        if hit is not None and hit[0] == version:
            return hit[1]
        p = {k: v.detach().contiguous()
             for k, v in self.weights(dtype).items()}
        self._stacked[key] = (version, p)
        return p

    def forward(self, spec, diffusion_step, cond=None, cond_proj=None):
        return apply(self, spec, diffusion_step, cond, cond_proj)


def prepare_cond(net: DiffNet, cond: torch.Tensor, p: dict | None = None
                 ) -> torch.Tensor:
    """Project the conditioner through every layer's 1x1 conv at once (f32
    weights; ``p`` from :meth:`DiffNet.weights` when it must carry grad):
    cond [B, T, H] -> [L, B, T, 2C].  Samplers call it once per clip; the
    result is constant across the sampling loop."""
    p = net.stacked(torch.float32) if p is None else p
    return (torch.einsum("bth,lhc->lbtc", cond.float(), p["wc"].float())
            + p["bc"].float()[:, None, None, :])


def step_embedding(p: dict, t: torch.Tensor, c: int) -> torch.Tensor:
    """Diffusion-step MLP: [N] int steps -> [N, C] f32, computed in f32 with
    the compute-dtype weights (as JAX promotes bf16 weights against the f32
    sinusoidal embedding)."""
    x = fnn.sinusoidal_pos_emb(t, c)
    x = fnn.mish(fnn.linear(x, p["w1"].float(), p["b1"].float()))
    return fnn.linear(x, p["w2"].float(), p["b2"].float())


def step_bias(p: dict, step: torch.Tensor, dtype) -> torch.Tensor:
    """Per-layer step bias: step [N, C] -> [L, N, C] in ``dtype``."""
    step = step.to(dtype).float()
    return (torch.einsum("nc,lcd->lnd", step, p["dp_w"].float())
            + p["dp_b"].float()[:, None, :]).to(dtype)


def apply(net: DiffNet, spec, diffusion_step, cond=None, cond_proj=None, *,
          train_stream: str | None = None, seq: int = 1,
          pallas_train: str = "auto", plain: bool = False):
    """Predict noise.  The compute dtype is ``spec.dtype`` (f32 or bf16).

    :param spec: [B, T, M] noisy mel
    :param diffusion_step: [B] int timestep
    :param cond: [B, T, H] conditioner, or a precomputed ``cond_proj``
        [L, B, T, 2C]
    :param train_stream: None serves through K1 on the cached weights; a
        ``diffnet_train_stream_dtype`` ("bf16" or "f32") takes the training
        route that :func:`train_route` picks for the batch's shape
        (``diffsvc_tpu/models/diffnet.py:219-295``): K4 at that stream, K5,
        or K4 at the f32 stream, with their backward when grad is enabled;
        K1 on operands rounded through the route's stream when not
        (validation's loss)
    :param seq: the seq axis of the training grid (> 1: a seq rank's
        window, always the scan route)
    :param pallas_train: ``diffnet_pallas_train`` ("off": always the scan
        route)
    :param plain: CPU trace only: the uncached :meth:`DiffNet.weights` and
        K1's plain version (``residual_stack_plain``), serving's numbers
        without the kernel.  The ONNX export traces this route
        (``onnx/svc_export.py``), since a CUDA kernel cannot be traced; on
        another device it raises, so no caller skips K1 on the card
    :return: [B, T, M] noise prediction in the compute dtype
    """
    if plain and spec.device.type != "cpu":
        raise ValueError("plain=True traces on the CPU; on "
                         f"{spec.device.type} the denoiser runs K1")
    dt = spec.dtype
    grad = train_stream is not None and torch.is_grad_enabled()
    fresh = grad or plain
    p = net.weights(dt) if fresh else net.stacked(dt)
    c, n_layers = net.residual_channels, net.n_layers
    x = torch.relu(spec.float() @ p["win"].float() + p["bin"].float()).to(dt)
    step = step_embedding(p, diffusion_step, c)
    sb = step_bias(p, step, dt)                                  # [L, B, C]
    if cond_proj is None:
        cond_proj = prepare_cond(net, cond, p if fresh else None)
    cond_proj = cond_proj.to(dt).contiguous()
    if plain:
        skip = diffnet_stack.residual_stack_plain(
            x, sb, cond_proj, p["wd"], p["bd"], p["wo"], p["bo"],
            cycle=net.cycle)
    elif train_stream is None:
        skip = diffnet_stack.residual_stack(
            x.contiguous(), sb, cond_proj, p["wd"], p["bd"], p["wo"],
            p["bo"], cycle=net.cycle)
    else:
        b, t = spec.shape[:2]
        route = train_route(n_layers, net.cycle, t, c, b, train_stream,
                            seq, pallas_train)
        ops = (x, sb, cond_proj, p["wd"], p["bd"], p["wo"], p["bo"])
        if route == "per_sample":
            skip = diffnet_stack_per_sample.residual_stack_train(
                *ops, cycle=net.cycle)
        else:
            skip = diffnet_stack_train.residual_stack_train_batched(
                *ops, cycle=net.cycle,
                stream=train_stream if route == "batched" else "f32")
    x = (skip * (1.0 / math.sqrt(n_layers))).to(dt)
    x = torch.relu(x.float() @ p["wskip"].float() + p["bskip"].float()).to(dt)
    return (x.float() @ p["wout"].float() + p["bout"].float()).to(dt)
