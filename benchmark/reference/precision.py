"""Where the reference rounds: every product of a network part goes through
:func:`q`, which is the identity in the reference (f32 with TF32 off) and,
in a control run, rounds both operands to the precision one step below the
one the configuration states for that part (bf16 -> fp8 e4m3 with a
per-tensor scale, f32 -> bf16); the song check's scale rounds the parts
stated below f32 at their stated precision.  The rounding is on the
operands, the products and sums stay f32, as a lower-precision kernel with
an f32 accumulator would run them."""

from __future__ import annotations

import contextlib

import torch

LOWER = {"bf16": "fp8", "f32": "bf16"}
_ROUND: dict = {}       # part -> "bf16" | "fp8" while a control runs
FP8_MAX = 448.0


def q(x: torch.Tensor, part: str) -> torch.Tensor:
    kind = _ROUND.get(part)
    if kind is None:
        return x
    if kind == "bf16":
        return x.to(torch.bfloat16).float()
    amax = x.detach().abs().amax().clamp(min=1e-30)
    scale = amax / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def lowered_kinds(precision: dict) -> dict:
    """part -> rounding one step below the precision each part states."""
    return {p: LOWER[v] for p, v in precision.items() if v in LOWER}


def stated_kinds(precision: dict) -> dict:
    """part -> rounding at the precision each part states, for the parts
    that state less than f32 (f32 is the reference's own)."""
    return {p: v for p, v in precision.items() if v in ("bf16", "fp8")}


@contextlib.contextmanager
def rounded(kinds: dict):
    """Run the block with each part of ``kinds`` (part -> "bf16" | "fp8")
    rounded so, and no other part."""
    prev = dict(_ROUND)
    _ROUND.clear()
    _ROUND.update(kinds)
    try:
        yield
    finally:
        _ROUND.clear()
        _ROUND.update(prev)


def lowered(precision: dict):
    """Run the block with every part of ``precision`` (part -> stated
    precision) one step lower."""
    return rounded(lowered_kinds(precision))


@contextlib.contextmanager
def exact_f32():
    """f32 products in true f32 (no TF32) inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def linear(x, w, b, part):
    return torch.nn.functional.linear(q(x, part), q(w, part), b)


def conv1d(x, w, b, part, **kw):
    return torch.nn.functional.conv1d(q(x, part), q(w, part), b, **kw)


def conv_transpose1d(x, w, b, part, **kw):
    return torch.nn.functional.conv_transpose1d(q(x, part), q(w, part), b,
                                                **kw)
