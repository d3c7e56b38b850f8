"""Random weights from the run's seed, made on the device in one draw per
network.

The recipe is the benchmark's own (the port's ``utils/synth.randomize``
draws torch's default init leaf by leaf on the host; this draws the same
distributions in one ``torch.rand`` call per network on the card):
linear and convolution weights and biases U(-1/sqrt(fan_in), 1/sqrt(fan_in))
as torch's default init, the attention's packed in-projection Xavier-uniform,
normalization affines 1 + U(-0.1, 0.1) and U(-0.1, 0.1) (so that no norm is
the identity), embedding tables of unit-scale std hidden^-0.5 with the
padding row zero.  The same seed gives the same weights to the program and
to the plain reference, each of which receives the state dict.
"""

from __future__ import annotations

import math

import torch

from .reference import params

NETS = ("diffusion", "hubert", "generator", "pe")


def _scale(kind: str, shape, fan: int) -> tuple:
    """(multiplier, offset) of a U(-1, 1) draw for this parameter."""
    if kind == "uniform":
        return 1.0 / math.sqrt(fan), 0.0
    if kind == "xavier":
        return math.sqrt(6.0 / (shape[0] + shape[1])), 0.0
    if kind == "norm_w":
        return 0.1, 1.0
    if kind == "norm_b":
        return 0.1, 0.0
    if kind == "embed":
        return math.sqrt(3.0) * fan ** -0.5, 0.0
    if kind == "var":       # a running variance: 0.5 + U(0, 1)
        return 0.5, 1.0
    raise ValueError(kind)


def state_dict(spec: list, seed: int, device, salt: int) -> dict:
    """{name: f32 tensor on ``device``} for a ``reference.params`` list, from
    one U(-1, 1) draw of a generator seeded by (``seed``, ``salt``)."""
    total = sum(math.prod(shape) for _, shape, _, _ in spec)
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * 8 + int(salt)) % (2 ** 63 - 1))
    flat = torch.rand(total, generator=g, device=device).mul_(2.0).sub_(1.0)
    out, at = {}, 0
    for name, shape, kind, fan in spec:
        n = math.prod(shape)
        if kind == "count":     # a BatchNorm's step counter
            out[name] = torch.zeros(shape, dtype=torch.long, device=device)
            continue
        mul, add = _scale(kind, shape, fan)
        t = flat[at: at + n].view(shape).mul_(mul).add_(add)
        if kind == "embed":
            t[0].zero_()
        out[name] = t
        at += n
    return out


def make(config: dict, seed: int, device) -> dict:
    """The networks' state dicts of a configuration file (pe where it
    names one)."""
    hp, voc = config["hparams"], config["vocoder"]
    specs = {"diffusion": params.diffusion(hp),
             "hubert": params.hubert(config["hubert"]),
             "generator": params.generator(voc, bool(hp.get("use_nsf", True)))}
    if "pe" in config:
        specs["pe"] = params.pe(hp, int(config["pe"]["conv_layers"]))
    return {net: state_dict(specs[net], seed, device, NETS.index(net))
            for net in specs}
