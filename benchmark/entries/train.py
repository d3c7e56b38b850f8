"""The voice owner's training job: ``diffsvc_tpu_torch.training.task.
SVCTask.train_step`` on the route the configuration's batch takes, fed by
the port's own batch producer (``data/dataset.py``: ``build_batches`` by
``max_tokens`` / ``max_sentences``, ``BatchIterator`` padding lengths to
``frames_multiple``, ``prefetch`` a thread ahead, the sample mask the
trainer adds) over an in-memory binarized corpus, cycled epoch by epoch as
``Trainer.fit`` cycles it.

Set-up builds one task with the weights from the seed and drives it
through the feed's whole first epoch, one step per batch (every row
distinct, and every padded batch shape the window will meet, each on the
route ``train_route`` picks for it), recording each step's loss, the
optimizer's state after the first step and the parameters after the
third; that same task then runs the window, whose epochs are the same
batches in other orders.  Every step's t and noise come from the
benchmark's generator on the card and go in through ``train_step(t=,
noise=)``.  After the window the plain reference follows the set-up's
steps from the same weights, batches, t and noise: each step's loss, the
first gradient and the change after three steps are compared leaf by
leaf.
"""

from __future__ import annotations

import gc
import os
import shutil
import statistics
import tempfile
import time

import numpy as np
import yaml

from benchmark import harness, weights
from benchmark.reference import params as ref_params
from benchmark.reference import precision
from benchmark.reference import train as ref_train

FOLLOWED = 3      # the steps whose change of the parameters is compared


def corpus_dataset(items: list, hp):
    """The port's ``FastSpeechDataset`` over items held in memory (its
    sizes, item access, ``getitem`` and collater as they are)."""
    from diffsvc_tpu_torch.data.dataset import FastSpeechDataset

    class Corpus(FastSpeechDataset):
        def __init__(self):
            self.prefix, self.hp, self.shuffle = "train", hp, True
            self.sort_by_len = bool(hp.get("sort_by_len", True))
            self.sizes = np.array([len(it["mel"]) for it in items])
            self.indexed_ds, self.avail_idxs = None, None

        def _get_item(self, index):
            return items[index]

    return Corpus()


def feed(ds, hp):
    """Batches epoch after epoch, as ``Trainer.fit`` makes them at one
    process (its epoch-seeded shuffle, its sample mask)."""
    from diffsvc_tpu_torch.data.dataset import (BatchIterator, _pad_batch_dim,
                                                build_batches, prefetch)

    pad = int(hp.get("frames_multiple", 128))
    epoch = 0
    while True:
        rng = np.random.RandomState(int(hp.get("seed", 1234)) + epoch)
        it = BatchIterator(ds, build_batches(ds, hp, num_replicas=1, rng=rng),
                           pad_multiple=pad)
        yield from prefetch(iter(it), lambda b: _pad_batch_dim(
            b, b["nsamples"]), depth=2)
        epoch += 1


def epoch_len(ds, hp) -> int:
    """Batches in one of the feed's epochs."""
    from diffsvc_tpu_torch.data.dataset import build_batches

    rng = np.random.RandomState(int(hp.get("seed", 1234)))
    return len(build_batches(ds, hp, num_replicas=1, rng=rng))


def first_count(ds, hp) -> int:
    """Steps set-up runs: the first epoch, and at least ``FOLLOWED``."""
    return max(epoch_len(ds, hp), FOLLOWED)


def make_task(config: dict, device: str, tmp: str):
    from diffsvc_tpu_torch.config import set_hparams
    from diffsvc_tpu_torch.training.task import SVCTask

    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(config["hparams"], work_dir=tmp), f)
    hp = set_hparams(config=path, exp_name="bench", reset=True,
                     print_hparams=False)
    return SVCTask(hp, device=device), hp


def diffusion_weights(config: dict, seed: int, device) -> dict:
    return weights.state_dict(ref_params.diffusion(config["hparams"]), seed,
                              device, weights.NETS.index("diffusion"))


def run(r: harness.Run) -> None:
    import torch

    cfg = r.config
    tmp = tempfile.mkdtemp(prefix="bench_train_")
    task, hp = make_task(cfg, r.device, tmp)
    shutil.rmtree(tmp, ignore_errors=True)
    task.load_params(diffusion_weights(cfg, r.seed, r.device))
    gen = harness.load_module("generators", r.traffic["generator"], r.root)
    ds = corpus_dataset(gen.items(r.traffic, cfg["hparams"], r.seed), hp)
    batches = feed(ds, hp)
    g = torch.Generator(device=r.device).manual_seed(
        (r.seed * 2654435761 + 17) % (2 ** 63))
    k_step, mels = int(hp["K_step"]), int(hp["audio_num_mel_bins"])

    def step(batch):
        shape = np.shape(batch["mels"])
        t = torch.randint(0, k_step, shape[:1], generator=g, device=r.device)
        noise = torch.randn(shape, generator=g, device=r.device)
        return task.train_step(batch, t=t, noise=noise), t, noise

    # the first epoch: warm-up of every batch shape, and what the
    # reference follows
    first, losses = [], []
    for i in range(first_count(ds, hp)):
        batch = next(batches)
        out, t, noise = step(batch)
        first.append((batch, t, noise))
        losses.append(out["loss"])
        if i == FOLLOWED - 1:
            theta3 = {n: p.detach().clone()
                      for n, p in zip(task.names, task.params)}
        if i == 0:
            b1 = float(hp["optimizer_adam_beta1"])
            # the first gradient as AdamW got it: its first moment after
            # one step is (1 - beta1) g (none, where it took no step)
            grad1 = {n: task.optimizer.state.get(p, {}).get(
                "exp_avg", torch.zeros_like(p)).detach() / (1 - b1)
                for n, p in zip(task.names, task.params)}
    losses = [float(x) for x in losses]

    steps, frames = [], 0
    with r.window():
        while True:
            with r.span("fetch"):
                batch = next(batches)
            with r.span("step"):
                step(batch)
            lens = [int(x) for x in batch["mel_lengths"]]
            steps.append((len(lens), int(np.shape(batch["mels"])[1]), lens))
            frames += sum(lens)
            if time.perf_counter() - r.t0 >= r.seconds:
                break
    window_s = r.t1 - r.t0
    r.attempted = len(steps)
    r.e2e["train_frames_rate"] = frames / window_s
    r.counters["window_s"] = window_s
    r.work = [{"kind": "step", "rows": b, "frames": t, "lengths": lens}
              for b, t, lens in steps]
    harness.log(f"window: {len(steps)} steps, {frames} frames in "
                f"{window_s:.3f} s; set-up {r.setup_s:.2f} s; first losses "
                f"{losses}")
    del task, batches, step
    gc.collect()
    if r.device == "cuda":
        torch.cuda.empty_cache()
    check(r, cfg, hp, first, losses, grad1, theta3)


def leaf_gaps(prog: dict, ref: dict, names) -> tuple:
    """(worst leaf gap, its name): |‖p‖ - ‖r‖| over the larger of ‖r‖ and
    the median leaf's ‖r‖."""
    norms = {n: (float(prog[n].double().norm()), float(ref[n].double().norm()))
             for n in names}
    med = statistics.median(r for _, r in norms.values())
    worst = max(names, key=lambda n: abs(norms[n][0] - norms[n][1])
                / max(norms[n][1], med))
    p, r = norms[worst]
    return abs(p - r) / max(r, med), worst


def compare(ref: dict, losses, grad1, theta0, theta3) -> dict:
    """The three numbers a training run holds: the worst step's relative
    loss gap, the worst leaf's gap of the first gradient's norm, the worst
    leaf's gap of the change after ``FOLLOWED`` steps; leaves whose reference
    gradient is under a thousandth of the median leaf's are left out."""
    gnorm = {n: float(g.double().norm()) for n, g in ref["grad1"].items()}
    med = statistics.median(gnorm.values())
    names = [n for n in gnorm if gnorm[n] >= 1e-3 * med]
    loss_gap = max(abs(p - q) / abs(q) for p, q in zip(losses,
                                                       ref["losses"]))
    g_gap, g_leaf = leaf_gaps(grad1, ref["grad1"], names)
    d_prog = {n: theta3[n].to(theta0[n].device) - theta0[n] for n in names}
    d_ref = {n: ref["params"][n] - theta0[n] for n in names}
    u_gap, u_leaf = leaf_gaps(d_prog, d_ref, names)
    return {"loss_gap": loss_gap, "grad_gap": g_gap, "grad_leaf": g_leaf,
            "update_gap": u_gap, "update_leaf": u_leaf,
            "left_out": sorted(set(gnorm) - set(names))}


def check(r, cfg, hp, first, losses, grad1, theta3) -> None:
    theta0 = diffusion_weights(cfg, r.seed, r.device)
    t0 = time.perf_counter()
    with precision.exact_f32():
        ref = ref_train.run_steps(theta0, cfg["hparams"], first, r.device,
                                  keep=FOLLOWED)
    got = compare(ref, losses, grad1, theta0, theta3)
    harness.log(f"check: {got} (reference {time.perf_counter() - t0:.2f} s;"
                f" losses {losses} vs {ref['losses']})")
    lim = r.workload["check"]["limits"]
    r.checks = [(k, float(got[k]), float(lim[k]))
                for k in ("loss_gap", "grad_gap", "update_gap")]


def first_steps(cfg: dict, mix: dict, seed: int, device, root=None) -> list:
    """The batches of ``seed`` that a run's set-up steps on, with their t
    and noise, drawn as a run draws them."""
    import torch

    tmp = tempfile.mkdtemp(prefix="bench_train_")
    from diffsvc_tpu_torch.config import set_hparams

    path = os.path.join(tmp, "config.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(dict(cfg["hparams"], work_dir=tmp), f)
    hp = set_hparams(config=path, exp_name="bench", reset=True,
                     print_hparams=False)
    shutil.rmtree(tmp, ignore_errors=True)
    gen = harness.load_module("generators", mix["generator"],
                              root or harness.BENCH)
    ds = corpus_dataset(gen.items(mix, cfg["hparams"], seed), hp)
    batches = feed(ds, hp)
    g = torch.Generator(device=device).manual_seed(
        (seed * 2654435761 + 17) % (2 ** 63))
    out = []
    for _ in range(first_count(ds, hp)):
        batch = next(batches)
        shape = np.shape(batch["mels"])
        t = torch.randint(0, int(hp["K_step"]), shape[:1], generator=g,
                          device=device)
        out.append((batch, t, torch.randn(shape, generator=g,
                                          device=device)))
    return out


def reference_steps(wl: dict, cfg: dict, mix: dict, seed: int, device,
                    rows=None, first=None) -> dict:
    """The reference's steps on a run's set-up batches, with the weights
    it starts from (``theta0``)."""
    first = first or first_steps(cfg, mix, seed, device)
    theta0 = diffusion_weights(cfg, seed, device)
    out = ref_train.run_steps(theta0, cfg["hparams"], first, device,
                              rows=rows, keep=FOLLOWED)
    return dict(out, theta0=theta0)


def control(r: harness.Run) -> dict:
    """The control's and the faults' readings at the cell's size: the
    reference with TF32 on (the step below the stated f32), and the
    reference with half of each batch left out, each against the
    reference."""
    import torch

    wl, cfg, mix, seed, device = (r.workload, r.config, r.traffic, r.seed,
                                  r.device)
    first = first_steps(cfg, mix, seed, device, r.root)
    with precision.exact_f32():
        ref = reference_steps(wl, cfg, mix, seed, device, first=first)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    try:
        tf32 = reference_steps(wl, cfg, mix, seed, device, first=first)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    n = int(np.shape(first[0][0]["mels"])[0])
    with precision.exact_f32():
        half = reference_steps(wl, cfg, mix, seed, device,
                               rows=slice(0, n // 2), first=first)
    out = {}
    for name, other in (("tf32", tf32), ("half_batch", half)):
        out[name] = compare(ref, other["losses"], other["grad1"],
                            ref["theta0"], other["params"])
        harness.log(f"control {name}: {out[name]}")
    r.attempted = len(first)
    return out
