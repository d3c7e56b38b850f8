"""Ranks of the port's data-parallel tests (``tests/test_torch_parallel.py``),
spawned by ``torch.multiprocessing.spawn`` over gloo on the CPU.  No JAX
here: a spawned rank imports only this module and the port.

Each job reads its inputs from a ``torch.save`` file and writes what it saw
to ``<out>/rank<r>.pt``.
"""

import os

import torch

from diffsvc_tpu_torch.config import HParams
from diffsvc_tpu_torch.models import diffnet
from diffsvc_tpu_torch.parallel import dist


def _svc_steps(args, rank):
    """SVCTask steps on the global batch with the given draws; per step the
    grads summed over ranks, the metrics and the params after it, and the
    batch sizes ``diffnet.train_route`` was asked about."""
    from diffsvc_tpu_torch.training.task import SVCTask

    routes = []
    real = diffnet.train_route

    def route(*a):
        routes.append(a[4])
        return real(*a)

    diffnet.train_route = route
    task = SVCTask(HParams(args["hp"]), device="cpu")
    task.model.load_state_dict(args["sd"])
    steps = []
    for t, noise in args["draws"]:
        loss, grads = task.loss_and_grads(args["batch"], t=t, noise=noise)
        summed = dist.all_reduce_sum([*grads, loss])
        m = task.train_step(args["batch"], t=t, noise=noise)
        steps.append({"loss": float(m["loss"]), "grad_norm":
                      float(m["grad_norm"]), "grads": summed[:-1],
                      "params": {k: v.clone() for k, v in
                                 task.model.state_dict().items()}})
    return {"steps": steps, "routes": routes, "names": task.names}


def _pe_step(args, rank):
    """One PitchExtractionTask step on the global batch."""
    from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask

    task = PitchExtractionTask(HParams(args["hp"]), device="cpu")
    task.model.load_state_dict(args["sd"])
    loss, losses, grads = task.loss_and_grads(args["batch"])
    summed = dist.all_reduce_sum(grads)
    m = task.train_step(args["batch"])
    return {"loss": float(m["loss"]), "grads": summed, "names": task.names,
            "params": {k: v.clone() for k, v in
                       task.model.state_dict().items()}}


def _restore(args, rank):
    """A Trainer on this rank's own work_dir (only rank 0's holds a
    checkpoint): its state after ``restore()``."""
    from diffsvc_tpu_torch.training.trainer import Trainer

    hp = HParams(args["hp"], work_dir=args["work_dirs"][rank])
    trainer = Trainer(hp, device="cpu", log_writer=False)
    restored = trainer.restore()
    return {"restored": restored, "epoch": trainer.epoch,
            "global_step": trainer.global_step, "best": trainer.best,
            "task_step": trainer.task.step,
            "state": trainer.task.state_dict()}


JOBS = {"svc_steps": _svc_steps, "pe_step": _pe_step, "restore": _restore}


def nccl_world1(_, store, args_path, out_dir):
    """The card's world-1 check: SVCTask steps on ``cuda:0`` with no
    process group, then the same steps from the same fresh state under
    nccl at world 1 (its all-reduce the identity); deterministic
    algorithms, so equal inputs give equal bits.  Writes whether params and
    optimizer state came out bit-equal."""
    os.environ.update(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
                      CUBLAS_WORKSPACE_CONFIG=":4096:8")
    from diffsvc_tpu_torch.training.task import SVCTask

    torch.use_deterministic_algorithms(True)
    args = torch.load(args_path, weights_only=False)
    runs = []
    for mode in ("single", "nccl"):
        if mode == "nccl":
            dist.maybe_initialize_distributed(
                {"distributed": True}, device="cuda:0",
                init_method=f"file://{store}")
        task = SVCTask(HParams(args["hp"]), device="cuda:0")
        for batch in args["batches"]:
            task.train_step(batch)
        st = task.optimizer.state_dict()["state"]
        runs.append([p.detach().cpu() for p in task.params]
                    + [v.cpu() for i in sorted(st) for _, v in
                       sorted(st[i].items())])
    backend = torch.distributed.get_backend()
    dist.destroy()
    torch.save({"backend": backend, "bit_equal": len(runs[0]) == len(runs[1])
                and all(torch.equal(a, b) for a, b in zip(*runs))},
               os.path.join(out_dir, "rank0.pt"))


def run(rank, world, store, job, args_path, out_dir):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    dist.maybe_initialize_distributed({"distributed": True}, device="cpu",
                                      init_method=f"file://{store}")
    try:
        out = JOBS[job](torch.load(args_path, weights_only=False), rank)
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy()
