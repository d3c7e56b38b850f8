"""The port's data-parallel training and sharded serving on the CPU.

Two gloo ranks (``torch.multiprocessing.spawn``, a ``file://`` store under
the test's tmp_path, so parallel test workers never share a port) run
``tests/_torch_dist_worker.py``'s jobs; each rank holds the global batch
and takes its contiguous block.  They are held against the JAX package's
step on a 2-device ``data`` mesh (two of conftest's 8 virtual CPU devices),
against the one-process sum of the two blocks' gradients, and against each
other.  ``FusedSvc.batched_sharded`` over two CPU "devices" is held
against JAX's on a 2-device mesh and the port's own ``batched``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import _torch_dist_worker
from _torch_fixtures import TINY_HP
from diffsvc_tpu.config import HParams
from diffsvc_tpu.models import pe as jpe
from diffsvc_tpu.parallel import mesh as mesh_lib
from diffsvc_tpu.training import pe_task as jpe_task
from diffsvc_tpu.training.task import SVCTask as JTask
from diffsvc_tpu_torch.models import diffnet
from diffsvc_tpu_torch.parallel import dist
from diffsvc_tpu_torch.training import checkpoint as ckpt_lib
from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask
from diffsvc_tpu_torch.training.task import SVCTask, local_rows, real_rows
from diffsvc_tpu_torch.utils.convert import diffusion_jax_to_torch

WORLD = 2


def _spawn(tmp_path, job, args):
    args_path = str(tmp_path / f"{job}_args.pt")
    torch.save(args, args_path)
    out = tmp_path / f"{job}_out"
    out.mkdir()
    mp.spawn(_torch_dist_worker.run,
             args=(WORLD, str(tmp_path / f"{job}_store"), job, args_path,
                   str(out)), nprocs=WORLD, join=True)
    return [torch.load(str(out / f"rank{r}.pt"), weights_only=False)
            for r in range(WORLD)]


def _mesh():
    return mesh_lib.make_mesh(("data",), devices=jax.devices()[:WORLD])


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


def test_unconfigured_process_stays_single(monkeypatch):
    """Without ``distributed: true`` or torchrun's environment nothing
    starts: world 1, rank 0, the whole batch is the block, a sum over ranks
    is the identity, and a state comes back as it is."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    assert not dist.maybe_initialize_distributed({"distributed": False})
    assert not dist.maybe_initialize_distributed(None)
    assert not dist.is_initialized()
    assert (dist.world_size(), dist.rank()) == (1, 0)
    assert dist.block(6) == slice(0, 6)
    assert dist.block(6, 1, 2) == slice(3, 6)
    with pytest.raises(ValueError):
        dist.block(5, 0, 2)
    x = [torch.ones(3)]
    assert dist.all_reduce_sum(x)[0] is x[0]
    state = {"a": torch.zeros(2)}
    assert dist.broadcast_state(state) is state


def test_no_card_and_no_device_raises_before_a_group(monkeypatch):
    """``distributed: true`` with no card and no device asked for raises
    as every entry point does, and no process group starts; asked for the
    CPU it goes on to the group (here stopped at its rendezvous, which the
    environment lacks)."""
    for k in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    started = []
    monkeypatch.setattr(torch.distributed, "init_process_group",
                        lambda *a, **k: started.append((a, k)))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.maybe_initialize_distributed({"distributed": True})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dist.maybe_initialize_distributed({"distributed": True},
                                          device="cuda")
    assert started == [] and not dist.is_initialized()
    with pytest.raises(KeyError, match="WORLD_SIZE"):
        dist.maybe_initialize_distributed({"distributed": True},
                                          device="cpu")
    assert started == []


# ---------------------------------------------------------------- SVCTask --

HP = dict(
    audio_num_mel_bins=16, hidden_size=32, residual_layers=4,
    residual_channels=32, dilation_cycle_length=4, timesteps=20, K_step=20,
    diff_loss_type="l1", schedule_type="linear", max_beta=0.02, keep_bins=16,
    spec_min=[-6.0], spec_max=[1.5], no_fs2=True, use_pitch_embed=True,
    use_energy_embed=False, use_uv=False, pitch_norm="log", f0_bin=256,
    f0_min=50.0, f0_max=1100.0, lr=1e-3, scheduler="step_lr",
    decay_steps=100, optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98,
    weight_decay=0, clip_grad_norm=1, accumulate_grad_batches=1, seed=0,
    diffnet_train_stream_dtype="f32")


def _svc_batch(seed=0, n=3, b=4, tm=32, tp=16):
    """A collated batch of ``n`` real rows padded to ``b`` with
    ``sample_mask`` (a ragged last batch), the real rows of unequal
    lengths."""
    rng = np.random.RandomState(seed)
    mel2ph = np.clip((np.arange(tm)[None] * tp // tm) + 1, 1, tp).astype(
        np.int32) * np.ones((b, 1), np.int32)
    mel2ph[1, 24:] = 0
    batch = {"hubert": rng.randn(b, tp, 32).astype(np.float32) * 0.3,
             "mel2ph": mel2ph,
             "f0": (7.6 + 0.2 * rng.randn(b, tm)).astype(np.float32),
             "uv": np.zeros((b, tm), np.float32),
             "energy": np.zeros((b, tm), np.float32),
             "mels": rng.randn(b, tm, 16).astype(np.float32),
             "sample_mask": (np.arange(b) < n).astype(np.float32)}
    for k in ("hubert", "mel2ph", "f0", "mels"):
        batch[k][n:] = 0
    return batch


def _jax_step_draws(batch, step):
    """The JAX step's t and noise at the global (padded) batch."""
    rng = jax.random.fold_in(jax.random.PRNGKey(0), step)
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (batch["mels"].shape[0],), 0, 20)
    noise = jax.random.normal(n_rng, batch["mels"].shape, jnp.float32)
    return rng, torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


@pytest.fixture(scope="module")
def svc_run(tmp_path_factory):
    """Two steps of the JAX task on a 2-device mesh and of the port's task
    on two gloo ranks, from the same params (a nonzero DiffNet head), batch
    and draws."""
    tmp = tmp_path_factory.mktemp("torch_parallel")
    hp = HParams(HP)
    jt = JTask(hp, mesh=_mesh())
    state = jt.init_state()
    op = state["params"]["denoise_fn"]["output_projection"]
    op["w"] = jnp.asarray(np.random.RandomState(3).randn(
        *op["w"].shape).astype(np.float32) * 0.2)
    state["opt_state"] = jt.tx.init(state["params"])
    p0 = diffusion_jax_to_torch(jax.tree.map(np.asarray, state["params"]))
    batch = _svc_batch()
    jax_steps, draws = [], []
    for step in range(2):
        rng, t, noise = _jax_step_draws(batch, step)
        draws.append((t, noise))
        jb = {k: jnp.asarray(v) for k, v in jt.prepare_batch(batch).items()}
        grads = jax.grad(lambda p: jt.model.training_loss(p, jb, rng)[0])(
            state["params"])
        state, m = jt.train_step(state, batch, jax.random.PRNGKey(0))
        jax_steps.append({"loss": float(m["loss"]), "grads":
                          diffusion_jax_to_torch(jax.tree.map(np.asarray,
                                                              grads)),
                          "params": diffusion_jax_to_torch(jax.tree.map(
                              np.asarray, state["params"]))})
    ranks = _spawn(tmp, "svc_steps", {"hp": dict(HP), "sd": p0,
                                      "batch": batch, "draws": draws})
    return hp, p0, batch, draws, jax_steps, ranks


def test_two_ranks_match_the_jax_mesh_step(svc_run):
    """Two steps on a ragged batch (3 real rows padded to 4): the loss
    within rtol 1e-5, the summed gradients within 1e-3 of each tensor's
    largest entry, the params after the first step within 2 lr (1e-6 where
    the gradient's sign is settled) and after the second within 4 lr:
    tests/test_torch_training.py's tolerances."""
    hp, p0, _, _, jax_steps, ranks = svc_run
    names = ranks[0]["names"]
    for i, (js, ts) in enumerate(zip(jax_steps, ranks[0]["steps"])):
        np.testing.assert_allclose(ts["loss"], js["loss"], rtol=1e-5)
        for name, g in zip(names, ts["grads"]):
            ref = js["grads"][name].numpy()
            assert np.abs(g.numpy() - ref).max() <= \
                1e-3 * np.abs(ref).max() + 1e-12, (i, name)
            upd = (ts["params"][name] - p0[name]).numpy()
            upd_ref = (js["params"][name] - p0[name]).numpy()
            assert np.abs(upd - upd_ref).max() <= 2 * (i + 1) * hp["lr"] \
                + 1e-6, (i, name)
            if i == 0:
                settled = np.abs(ref) > 1e-3 * np.abs(ref).max()
                np.testing.assert_allclose(upd[settled], upd_ref[settled],
                                           atol=1e-6, err_msg=name)


def test_two_ranks_sum_the_blocks_and_stay_equal(svc_run):
    """Each step's all-reduced gradients equal the sum of the two blocks'
    gradients computed in one process with the same draws and the global
    count (1e-5 rel-L2 per tensor; the loss 1e-6); the two ranks' params
    are equal bit for bit.  Normalizing each block by its own count of real
    rows (2 and 1 of 3: each block's grads scaled by 3 / its count) fails
    the same limit."""
    hp, p0, batch, draws, _, ranks = svc_run
    task = SVCTask(hp, device="cpu")
    task.model.load_state_dict(p0)
    n = batch["mels"].shape[0]
    for i, (t, noise) in enumerate(draws):
        loss, grads, bad = 0.0, 0.0, 0.0
        for r in range(WORLD):
            rows = dist.block(n, r, WORLD)
            lo, g = task.loss_and_grads(batch, t=t, noise=noise, rows=rows)
            scale = real_rows(batch) / real_rows(local_rows(batch, rows))
            loss = loss + lo
            grads = [a + b for a, b in zip(grads, g)] if r else g
            bad = [a + b * scale for a, b in zip(bad, g)] if r else \
                [b * scale for b in g]
        got = ranks[0]["steps"][i]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        assert max(_rel_l2(a, b) for a, b in zip(got["grads"], grads)) < 1e-5
        assert max(_rel_l2(a, b) for a, b in zip(got["grads"], bad)) > 1e-5
        for k, v in got["params"].items():
            assert torch.equal(v, ranks[1]["steps"][i]["params"][k]), k
        task.train_step(batch, t=t, noise=noise)


def test_route_is_decided_on_the_local_block(svc_run):
    """Every ``train_route`` call of a rank saw its block (2 rows), not the
    global batch (4), as JAX decides at ``b // n_dp``.  At the route test's
    sizes (20 layers in cycles of 4, T=1024, C=256, bf16) that is what
    flips a global 48: its 24-row blocks take K4, the whole batch would
    take K5."""
    *_, ranks = svc_run
    for r in ranks:
        assert r["routes"] and set(r["routes"]) == {2}
    assert diffnet.train_route(20, 4, 1024, 256, 48, "bf16") == "per_sample"
    assert diffnet.train_route(20, 4, 1024, 256, 48 // WORLD,
                               "bf16") == "batched"


# ---------------------------------------------------------------- pe task --

PE_HP = dict(TINY_HP, lr=1e-3, scheduler="step_lr", decay_steps=100,
             optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98,
             weight_decay=0.0, clip_grad_norm=1, pitch_type="frame",
             pitch_extractor_conv_layers=2, seed=5)


def test_pe_two_ranks_match_the_jax_mesh_step(tmp_path):
    """The pe task on two ranks against JAX's pe step on a 2-device mesh,
    a batch of 3 padded to 4 with one real row all but masked: the loss
    within rtol 1e-4, the summed grads within 1e-4 of each leaf's largest,
    the params within 2 lr (1e-6 where settled), as
    tests/test_torch_train_rest.py holds the single-device step."""
    hp = HParams(PE_HP)
    tt = PitchExtractionTask(hp, device="cpu")
    sd = {k: v.detach().clone() for k, v in tt.model.state_dict().items()}
    rng = np.random.RandomState(1)
    mels = (rng.randn(4, 40, 16) * 0.5 - 2.5).astype(np.float32)
    mels[1, 30:] = 0.0
    mels[3] = 0.0
    batch = {"mels": mels,
             "f0": (7.6 + 0.2 * rng.randn(4, 40)).astype(np.float32),
             "uv": (rng.rand(4, 40) < 0.25).astype(np.float32),
             "sample_mask": np.array([1, 1, 1, 0], np.float32)}
    jt = jpe_task.PitchExtractionTask(hp, mesh=_mesh())
    params = jpe.convert({k: v.numpy() for k, v in sd.items()})
    state = {"params": params, "opt_state": jt.tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    (lj, _), gj = jax.value_and_grad(jt._loss, has_aux=True)(
        params, jt.prepare_batch(batch, shard=False))
    new_state, mj = jt.train_step(state, batch, jax.random.PRNGKey(0))
    ranks = _spawn(tmp_path, "pe_step", {"hp": dict(PE_HP), "sd": sd,
                                         "batch": batch})
    got = ranks[0]
    np.testing.assert_allclose(got["loss"], float(mj["loss"]), rtol=1e-4)
    g_tree = jpe.convert(dict({k: v.numpy() for k, v in sd.items()},
                              **{n: g.numpy() for n, g in
                                 zip(got["names"], got["grads"])}))
    for a, b in zip(jax.tree.leaves(g_tree), jax.tree.leaves(gj)):
        b = np.asarray(b)
        assert np.abs(np.asarray(a) - b).max() <= 1e-4 * np.abs(b).max() \
            + 1e-12
    p_tree = jpe.convert({k: v.numpy() for k, v in got["params"].items()})
    for a, b, z, g in zip(jax.tree.leaves(p_tree),
                          jax.tree.leaves(new_state["params"]),
                          jax.tree.leaves(params), jax.tree.leaves(gj)):
        upd, ref = np.asarray(a) - np.asarray(z), np.asarray(b) - np.asarray(z)
        assert np.abs(upd - ref).max() <= 2 * hp["lr"] + 1e-6
        settled = np.abs(np.asarray(g)) > 1e-3 * np.abs(np.asarray(g)).max()
        np.testing.assert_allclose(upd[settled], ref[settled], atol=1e-6)
    for k, v in got["params"].items():
        assert torch.equal(v, ranks[1]["params"][k]), k


# ---------------------------------------------------------------- restore --

def test_broadcast_state_after_a_rank0_only_restore(tmp_path):
    """Only rank 0's work_dir holds a checkpoint (written after two steps,
    so the optimizer has state): after ``Trainer.restore`` rank 1 holds
    rank 0's weights, optimizer and accumulation state, epoch and step,
    bit for bit."""
    hp = HParams(HP, task_cls="SVCTask", work_dir=str(tmp_path / "w0"),
                 ema_decay=0.9)
    task = SVCTask(hp, device="cpu")
    for i in range(2):
        task.train_step(_svc_batch(i))
    os.makedirs(hp["work_dir"])
    ckpt_lib.save_checkpoint(hp["work_dir"], task.state_dict(), 3, 2)
    dirs = [hp["work_dir"], str(tmp_path / "w1")]
    r0, r1 = _spawn(tmp_path, "restore", {"hp": dict(hp), "work_dirs": dirs})
    assert r0["restored"] and not r1["restored"]
    for r in (r0, r1):
        assert (r["epoch"], r["global_step"], r["task_step"]) == (3, 2, 2)
    want = task.state_dict()
    for part in ("state_dict", "ema_state_dict"):
        for k, v in want[part].items():
            assert torch.equal(r1["state"][part][k], v), (part, k)
    s0 = r0["state"]["optimizer_states"][0]["state"]
    s1 = r1["state"]["optimizer_states"][0]["state"]
    assert s0.keys() == s1.keys() and s0
    for i in s0:
        for k in s0[i]:
            assert torch.equal(s0[i][k], s1[i][k]), (i, k)
    assert r1["state"]["accumulation"]["opt_steps"] == 2


# ------------------------------------------------------- sharded serving --

@pytest.fixture(scope="module")
def fused_sides(tmp_path_factory):
    """tests/test_torch_fused.py's tiny project and both Svcs."""
    from diffsvc_tpu.infer.svc import Svc as JSvc
    from diffsvc_tpu.models import hubert as jhubert
    from diffsvc_tpu_torch.infer import hubert_encoder
    from diffsvc_tpu_torch.infer.svc import Svc as TSvc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.utils.synth import write_hubert
    from _torch_fixtures import write_project
    from test_torch_fused import HUB

    root = tmp_path_factory.mktemp("torch_sharded")
    cfg_fn, ckpt = write_project(str(root / "proj"))
    hub_fn = str(root / "hubert_soft.pt")
    write_hubert(hub_fn, HubertConfig(**HUB), seed=2)
    cwd = os.getcwd()
    os.chdir(root)         # the Svcs keep ./infer_tools caches
    try:
        tsvc = TSvc("proj", cfg_fn, False, ckpt, device="cpu")
        jsvc = JSvc("proj", cfg_fn, False, ckpt)
    finally:
        os.chdir(cwd)
    jcfg = jhubert.HubertConfig(**HUB)
    return (tsvc, hubert_encoder.load(hub_fn, cfg=HubertConfig(**HUB)),
            jsvc, jhubert.load(hub_fn, jcfg), jcfg)


@pytest.mark.parametrize("n", [3, 4], ids=["ragged", "even"])
def test_batched_sharded_matches_jax_and_batched(fused_sides, n):
    """``FusedSvc.batched_sharded`` over two CPU devices, 3 chunks (padded
    to 4) or 4: against JAX's ``batched_sharded`` on a 2-device mesh with
    each chunk's draws from JAX's ``split(rng, n_padded)`` (waveform and
    mel within 2e-3, tests/test_torch_fused.py's limit against JAX), and
    against the port's own ``batched`` on the same draws (1e-5); one result
    per real chunk, as long as ``batched``'s."""
    from _torch_fixtures import voiced_wav
    from test_torch_fused import _jax_draws, _pair

    jf, tf = _pair(fused_sides)
    wavs = [voiced_wav(secs=0.5 + 0.15 * i, f0=180.0 + 40 * i, seed=i)
            for i in range(n)]
    n_pad = -(-n // WORLD) * WORLD
    rng = jax.random.PRNGKey(n)
    ref = jf.batched_sharded(wavs, _mesh(), rng=rng, key_shifts=1)
    g = tf.geometry(tf._padded_length(max(map(len, wavs))))
    draws = [_jax_draws(k, g["pad_t"], g["n_voc"])
             for k in jax.random.split(rng, n_pad)[:n]]
    noise = np.concatenate([d[0] for d in draws])
    randoms = tuple(np.concatenate([d[1][j] for d in draws])
                    for j in range(2))
    got = tf.batched_sharded(wavs, ["cpu", "cpu"], key_shifts=1,
                             init_noise=noise, voc_randoms=randoms)
    own = tf.batched(wavs, key_shifts=1, init_noise=noise,
                     voc_randoms=randoms)
    assert len(got) == len(ref) == len(own) == n
    for w, (gw, gf, gm), (rw, _, rm), (ow, of, om) in zip(wavs, got, ref,
                                                          own):
        assert len(gw) == len(ow) == min(len(w), g["n_voc"])
        np.testing.assert_allclose(gw, np.asarray(rw), atol=2e-3)
        np.testing.assert_allclose(gm, np.asarray(rm), atol=2e-3)
        np.testing.assert_allclose(gw, ow, atol=1e-5)
        np.testing.assert_allclose(gf, of, atol=1e-5)
        np.testing.assert_allclose(gm, om, atol=1e-5)
    assert tf.replica(0, "cpu") is tf
    rep = tf.replica(1, "cpu")
    assert rep is not tf and tf.replica(1, "cpu") is rep
