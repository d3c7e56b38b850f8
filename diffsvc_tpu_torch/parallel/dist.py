"""The process group of training, and its (data, seq) grid of ranks.

Counterpart of ``diffsvc_tpu/parallel/mesh.py``: where the JAX package
builds a ``data`` (or ``data,seq``) mesh over every device and lets XLA
insert the collectives, the port runs one process per card (``torchrun``,
or ``distributed: true`` with ``MASTER_ADDR``/``MASTER_PORT``/``RANK``/
``WORLD_SIZE``) joined by ``torch.distributed``.  Every rank holds the
whole global batch.  ``mesh_axes``/``mesh_shape`` lay the ranks out as the
JAX trainer lays out its devices (:func:`grid`): rank r sits at
(r // s, r % s) of a (data = d, seq = s) grid and takes the contiguous
block of rows (:func:`block`) and of frames (:func:`frames`) that
``NamedSharding(P("data", "seq"))`` would place on its device.  Where XLA
exchanges halos between the seq shards at every dilated conv, a seq rank
here computes its frames widened by the denoiser's receptive field
(:func:`halo`, :func:`window`) and nothing crosses ranks inside the layer
stack (``training/task.py``).

Only two collectives are used, ``all_reduce`` (SUM) and ``broadcast``, so
the same code runs under ``nccl`` (one card per rank) and under ``gloo``
(which takes CUDA tensors for exactly these two, and lets several ranks
share one card).
"""

from __future__ import annotations

import math
import os
from typing import Dict, List, NamedTuple, Sequence

import torch
import torch.distributed as dist

_ENV = ("WORLD_SIZE", "RANK")


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", rank()))


def backend_for(device, hp=None) -> str:
    """``nccl`` for a CUDA device, ``gloo`` otherwise; the ``dist_backend``
    hparam overrides (``gloo`` lets several ranks share one card)."""
    forced = str(hp.get("dist_backend", "") or "") if hp else ""
    if forced:
        return forced
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def maybe_initialize_distributed(hp=None, device=None,
                                 init_method: str | None = None) -> bool:
    """Start the process group when ``distributed: true`` is set or
    torchrun's ``WORLD_SIZE``/``RANK`` are in the environment (the
    counterpart of ``diffsvc_tpu/parallel/mesh.py:66-105``).  Rank and
    world size come from that environment; ``init_method`` defaults to
    ``env://`` (``MASTER_ADDR``/``MASTER_PORT``).  The backend is
    :func:`backend_for` the rank's device (``cuda:LOCAL_RANK`` unless
    ``device`` names a card or the CPU; with no card only an explicit CPU
    device starts a group, as ``infer.svc.default_device`` decides).  A
    second call does nothing; unconfigured, the process stays single.
    Returns True when more than one rank runs."""
    if is_initialized():
        return world_size() > 1
    want = bool(hp.get("distributed")) if hp else False
    want = want or all(os.environ.get(k) for k in _ENV)
    if not want:
        return False
    # the card unless the caller asks for the CPU, as every entry point:
    # no card and no device asked for raises before any group starts
    from ..infer.svc import default_device

    device = default_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", local_rank())
    backend = backend_for(device, hp)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        world_size=int(os.environ["WORLD_SIZE"]),
        rank=int(os.environ["RANK"]))
    print(f"| torch.distributed: rank {rank()}/{world_size()} on {device} "
          f"({backend})")
    return world_size() > 1


def destroy() -> None:
    """End the process group, when there is one."""
    if is_initialized():
        dist.destroy_process_group()


def block(n: int, r: int | None = None, w: int | None = None) -> slice:
    """Rank ``r``'s contiguous rows of a global batch of ``n`` (a multiple
    of the world size ``w``): ``[r n/w, (r+1) n/w)``, the placement of
    ``NamedSharding(P("data"))``."""
    r = rank() if r is None else r
    w = world_size() if w is None else w
    if n % w:
        raise ValueError(f"a batch of {n} does not split over {w} ranks")
    k = n // w
    return slice(r * k, (r + 1) * k)


class Grid(NamedTuple):
    """The (data, seq) grid of ranks: ``data`` blocks of the batch axis
    times ``seq`` blocks of the time axis."""
    data: int = 1
    seq: int = 1

    def cell(self, r: int) -> tuple:
        """Rank ``r``'s (data index, seq index): the position of device r
        in ``np.arange(world).reshape(data, seq)``."""
        return divmod(r, self.seq)


def grid(hp=None, world: int | None = None) -> Grid:
    """The grid that ``mesh_axes`` (``data``, the default, or
    ``data,seq``) and ``mesh_shape`` lay over ``world`` ranks (default the
    process group's), as ``diffsvc_tpu/training/trainer.py:79-83`` and
    ``parallel/mesh.py:23-31`` build the mesh: the default shape is
    [world, 1], and a shape whose product is not the world size raises.
    A single rank is the grid (1, 1) whatever the shape, as JAX builds no
    mesh on one device."""
    world = world_size() if world is None else int(world)
    hp = hp or {}
    axes = tuple(a.strip() for a in
                 str(hp.get("mesh_axes") or "data").split(","))
    if axes not in (("data",), ("data", "seq")):
        raise ValueError(f"mesh_axes {','.join(axes)!r}: the port lays out "
                         "'data' or 'data,seq'")
    if world == 1:
        return Grid(1, 1)
    shape = hp.get("mesh_shape")
    shape = [world] + [1] * (len(axes) - 1) if shape is None else \
        [int(n) for n in shape]
    if len(shape) != len(axes) or math.prod(shape) != world:
        raise ValueError(f"mesh_shape {shape} over mesh_axes "
                         f"{','.join(axes)!r} does not lay out {world} ranks")
    return Grid(*shape)


def data_world(hp=None) -> int:
    """The data axis's size: the batch is split over it, and the trainer
    batches and pads for it (``data_parallel_world_size``)."""
    return grid(hp).data


def data_index(hp=None, r: int | None = None) -> int:
    return grid(hp).cell(rank() if r is None else r)[0]


def seq_index(hp=None, r: int | None = None) -> int:
    return grid(hp).cell(rank() if r is None else r)[1]


def frames(t: int, j: int, s: int, axis: str = "time") -> slice:
    """Seq index ``j``'s own frames of a time axis of ``t``: ``[j t/s,
    (j+1) t/s)``, the placement of ``P(..., "seq")``.  A ``t`` that does
    not divide by ``s`` raises, as JAX's jit refuses it."""
    if t % s:
        raise ValueError(f"the {axis} axis of {t} frames does not split "
                         f"over the seq axis of {s}")
    k = t // s
    return slice(j * k, (j + 1) * k)


def halo(net, t: int) -> int:
    """Frames on each side of a seq block that its own outputs depend on:
    the wavenet's receptive radius, the sum of its dilations (each k=3
    layer of dilation 2^(i % cycle) reaches that far either side),
    ``(L / cycle) (2^cycle - 1)``: 75 at config_44k's 20 layers in cycles
    of 4.  The FFT denoiser attends over the whole clip: ``t``."""
    from ..models.diffnet import DiffNet

    if not isinstance(net, DiffNet):
        return t
    return net.n_layers // net.cycle * (2 ** net.cycle - 1)


def window(own: slice, t: int, h: int) -> slice:
    """The frames a seq rank computes: its own frames widened by the halo
    ``h`` on each side and clipped to ``[0, t)``."""
    return slice(max(own.start - h, 0), min(own.stop + h, t))


def all_reduce_sum(tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """SUM over ranks of every tensor, as one flat ``all_reduce`` (one
    collective however many tensors).  Without a process group the
    tensors come back as they are; at world size 1 the collective still
    runs (the identity: NCCL and gloo copy)."""
    if not is_initialized():
        return list(tensors)
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM)
    out, i = [], 0
    for t in tensors:
        out.append(flat[i: i + t.numel()].view(t.shape).to(t.dtype))
        i += t.numel()
    return out


def broadcast_state(state: Dict, src: int = 0, device=None) -> Dict:
    """Rank ``src``'s ``state`` on every rank (``sync_resume_state``,
    ``diffsvc_tpu/parallel/mesh.py:108-134``): a nested dict / list of
    tensors and plain values (the model, optimizer, EMA and accumulation
    state of a checkpoint, plus ``epoch``, ``global_step``, ``best``).  The
    structure, shapes and plain values travel as one byte tensor, then
    every tensor is broadcast on ``device`` (the rank's card under nccl)
    and comes back where rank ``src`` held it (CPU for a checkpoint).  A
    rank that restored nothing (a disk rank 0 alone wrote to) gets rank
    ``src``'s state all the same.  Without a process group ``state`` comes
    back as it is."""
    if not is_initialized():
        return state
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    tensors: List[torch.Tensor] = []

    def skeleton(x):
        if isinstance(x, torch.Tensor):
            tensors.append(x)
            return ("__tensor__", tuple(x.shape), str(x.dtype).split(".")[1],
                    str(x.device))
        if isinstance(x, dict):
            return {k: skeleton(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(skeleton(v) for v in x)
        return x

    box = [skeleton(state) if rank() == src else None]
    dist.broadcast_object_list(box, src=src, device=device)
    spec = box[0]

    def fill(x):
        if isinstance(x, tuple) and len(x) == 4 and x[0] == "__tensor__":
            _, shape, dtype, where = x
            if rank() == src:
                t = tensors[fill.i].to(device)
            else:
                t = torch.empty(shape, dtype=getattr(torch, dtype),
                                device=device)
            fill.i += 1
            dist.broadcast(t, src=src)
            return t.to(where if rank() == src else _home(where))
        if isinstance(x, dict):
            return {k: fill(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(fill(v) for v in x)
        return x

    fill.i = 0
    return fill(spec)


def _home(where: str) -> torch.device:
    """Where a receiving rank keeps a tensor that rank ``src`` held on
    ``where``: the CPU stays the CPU, a card becomes this rank's card."""
    d = torch.device(where)
    if d.type != "cuda":
        return d
    return torch.device("cuda", torch.cuda.current_device())
