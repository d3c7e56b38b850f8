"""The port's (data, seq) grid of ranks on the CPU: sequence-parallel
training, each rank on its rows and its window of frames (its own frames
widened by the denoiser's receptive field), against the JAX package's step
without a mesh and on the conftest's (4, 2) ``data,seq`` mesh
(``tests/test_seq_parallel.py``'s dims and tolerances), against the
unsharded port step, and with four gloo ranks spawned at (2, 2).  Also the
pe task and the trainer's batching under a seq axis, and ``use_remat``.
"""

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import jax
import jax.numpy as jnp

import _torch_dist_worker
from _torch_fixtures import TINY_HP
from diffsvc_tpu.config import HParams
from diffsvc_tpu.models import pe as jpe
from diffsvc_tpu.models.diffusion import GaussianDiffusion as JDiffusion
from diffsvc_tpu.parallel import mesh as mesh_lib
from diffsvc_tpu.training import pe_task as jpe_task
from diffsvc_tpu.training.task import SVCTask as JTask
from diffsvc_tpu_torch.models import diffnet
from diffsvc_tpu_torch.models.candidate_decoder import FFTDecoder
from diffsvc_tpu_torch.models.diffusion import GaussianDiffusion
from diffsvc_tpu_torch.parallel import dist
from diffsvc_tpu_torch.training import trainer as trainer_mod
from diffsvc_tpu_torch.training.pe_task import PitchExtractionTask
from diffsvc_tpu_torch.training.task import SVCTask, global_norm
from diffsvc_tpu_torch.utils.convert import diffusion_jax_to_torch

SEQ_TOL = 1e-5     # rel-L2 of a window sum against the unsharded port step


def _hp(**kw):
    """tests/test_seq_parallel.py's dims, the f32 train stream."""
    hp = HParams(
        audio_num_mel_bins=16, hidden_size=32, residual_layers=4,
        residual_channels=16, dilation_cycle_length=4, timesteps=20,
        K_step=20, diff_loss_type="l2", schedule_type="linear", max_beta=0.02,
        keep_bins=16, spec_min=[-6.0], spec_max=[1.5], no_fs2=True,
        use_pitch_embed=True, use_energy_embed=False, use_uv=False,
        pitch_norm="log", f0_bin=256, f0_min=50.0, f0_max=1100.0,
        lr=1e-3, scheduler="step_lr", decay_steps=100,
        optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98, weight_decay=0,
        clip_grad_norm=1, accumulate_grad_batches=1, seed=0,
        diffnet_train_stream_dtype="f32", enc_layers=2, dec_layers=2,
        enc_ffn_kernel_size=9, dec_ffn_kernel_size=9, num_heads=2,
        dropout=0.0)
    hp.update(kw)
    return hp


def _batch(b=4, t_mel=64, t_ph=32, h=32, m=16, real=None, seed=0):
    """tests/test_seq_parallel.py's batch with varied f0, row 1's last 16
    frames padding (mel2ph 0) and, with ``real``, the rows from ``real`` on
    padding rows (``sample_mask`` 0)."""
    rng = np.random.RandomState(seed)
    mel2ph = np.clip((np.arange(t_mel)[None, :] * t_ph // t_mel) + 1, 1, t_ph
                     ).astype(np.int32) * np.ones((b, 1), np.int32)
    mel2ph[1, t_mel - 16:] = 0
    batch = {
        "hubert": rng.randn(b, t_ph, h).astype(np.float32) * 0.1,
        "mel2ph": mel2ph,
        "f0": (7.6 + 0.2 * rng.randn(b, t_mel)).astype(np.float32),
        "uv": np.zeros((b, t_mel), np.float32),
        "energy": np.zeros((b, t_mel), np.float32),
        "mels": rng.randn(b, t_mel, m).astype(np.float32),
        "sample_mask": np.ones((b,), np.float32),
    }
    if real is not None:
        batch["sample_mask"][real:] = 0.0
        for k in ("hubert", "mel2ph", "f0", "mels"):
            batch[k][real:] = 0
    return batch


def _mesh(d, s):
    return mesh_lib.make_mesh(("data", "seq"), shape=(d, s),
                              devices=jax.devices()[:d * s])


def _jax_draws(batch, step=0):
    """The JAX step's key, t and noise at the global (padded) batch."""
    rng = jax.random.fold_in(jax.random.PRNGKey(0), step)
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (batch["mels"].shape[0],), 0, 20)
    noise = jax.random.normal(n_rng, batch["mels"].shape, jnp.float32)
    return rng, torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


def _jax_state(jt):
    """JAX's init with a random DiffNet head (a zero head zeroes every
    gradient but the head's)."""
    state = jt.init_state()
    net = state["params"]["denoise_fn"]
    if "output_projection" in net:
        op = net["output_projection"]
        op["w"] = jnp.asarray(np.random.RandomState(3).randn(
            *op["w"].shape).astype(np.float32) * 0.2)
        state["opt_state"] = jt.tx.init(state["params"])
    return state


def _port(hp, params, grid):
    task = SVCTask(hp, device="cpu", grid=grid)
    task.model.load_state_dict(diffusion_jax_to_torch(
        jax.tree.map(np.asarray, params)))
    return task


def window_sum(task, batch, t, noise):
    """Every (i, j) cell's loss and grads of the task's grid, in one
    process, summed (the ranks' SUM all-reduce)."""
    d, s = task.grid
    n, tm = batch["mels"].shape[:2]
    loss, grads = 0.0, None
    for i in range(d):
        for j in range(s):
            lo, g = task.loss_and_grads(batch, t=t, noise=noise,
                                        rows=dist.block(n, i, d),
                                        frames=dist.frames(tm, j, s))
            loss = loss + lo
            grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    return loss, grads


def _rel(a, b):
    num = sum(float((x - y).double().pow(2).sum()) for x, y in zip(a, b))
    den = sum(float(y.double().pow(2).sum()) for y in b)
    return (num / max(den, 1e-300)) ** 0.5


# ------------------------------------------------------------------ grid --

@pytest.mark.parametrize("shape", [(4, 2), (2, 4), (1, 2), (2, 1)])
def test_grid_follows_make_mesh(shape):
    """Rank r sits where ``make_mesh`` puts device r of
    ``mesh_shape`` over ``data,seq``; the data axis's size is JAX's
    ``data_parallel_world_size``."""
    n = shape[0] * shape[1]
    mesh = _mesh(*shape)
    g = dist.grid({"mesh_axes": "data,seq", "mesh_shape": list(shape)}, n)
    assert tuple(g) == shape
    assert g.data == mesh_lib.data_parallel_world_size(mesh)
    ids = [d.id for d in jax.devices()[:n]]
    for (i, j), dev in np.ndenumerate(mesh.devices):
        assert g.cell(ids.index(dev.id)) == (i, j)


def test_grid_defaults_and_refusals(monkeypatch):
    """The default shape is [world, 1] (data alone without ``mesh_axes``);
    a single rank is (1, 1) whatever the shape (JAX builds no mesh on one
    device); a shape that does not lay out the world, or another axis,
    raises."""
    assert dist.grid({"mesh_axes": "data,seq"}, 4) == dist.Grid(4, 1)
    assert dist.grid({}, 3) == dist.Grid(3, 1)
    assert dist.grid(None) == dist.Grid(1, 1)
    assert dist.grid({"mesh_axes": "data,seq", "mesh_shape": [2, 2]},
                     1) == dist.Grid(1, 1)
    with pytest.raises(ValueError, match="does not lay out 4 ranks"):
        dist.grid({"mesh_axes": "data,seq", "mesh_shape": [2, 3]}, 4)
    with pytest.raises(ValueError, match="mesh_axes"):
        dist.grid({"mesh_axes": "seq,data"}, 4)
    hp = {"mesh_axes": "data,seq", "mesh_shape": [2, 2]}
    monkeypatch.setattr(dist, "world_size", lambda: 4)
    assert dist.data_world(hp) == 2
    assert [dist.data_index(hp, r) for r in range(4)] == [0, 0, 1, 1]
    assert [dist.seq_index(hp, r) for r in range(4)] == [0, 1, 0, 1]


def test_halo_windows_and_divisibility():
    """H = 75 at config_44k's DiffNet (20 layers, cycles of 4) and 15 at
    the tests' 4 layers; a window is clipped at the clip's edges; the FFT
    denoiser's halo is the whole clip; a time axis, or a ``hubert`` length,
    that the seq axis does not divide raises, naming it."""
    with torch.device("meta"):
        big = diffnet.DiffNet(128, 256, 20, 384, 4)
    assert dist.halo(big, 4096) == 75
    tiny = diffnet.DiffNet(16, 32, 4, 16, 4)
    assert dist.halo(tiny, 64) == 15
    assert dist.halo(diffnet.DiffNet(16, 32, 8, 16, 2), 64) == 4 * 3
    assert dist.halo(FFTDecoder(16, 32, 16, 2), 64) == 64
    own = [dist.frames(64, j, 2) for j in range(2)]
    assert own == [slice(0, 32), slice(32, 64)]
    assert [dist.window(o, 64, 15) for o in own] == [slice(0, 47),
                                                    slice(17, 64)]
    assert dist.window(slice(16, 32), 64, 15) == slice(1, 47)
    assert dist.window(own[0], 64, 64) == slice(0, 64)
    with pytest.raises(ValueError, match="time axis of 61 frames"):
        dist.frames(61, 0, 2)
    task = SVCTask(_hp(), device="cpu", grid=dist.Grid(1, 2))
    with pytest.raises(ValueError, match="time axis of 61"):
        task.loss_and_grads(_batch(t_mel=61))
    with pytest.raises(ValueError, match="hubert axis of 31"):
        task.loss_and_grads(_batch(t_ph=31))


# ------------------------------------------------------- the step vs JAX --

CASES = {   # loss, rows real of 4, the grid summed, the JAX mesh
    "l2_mesh_none": ("l2", None, (4, 2), None),
    "l1_ragged_mesh_none": ("l1", 3, (2, 2), None),
    "l1_ragged_mesh_4x2": ("l1", 3, (4, 2), (4, 2)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_window_sum_matches_the_jax_step(case):
    """The sum of every (i, j) window's loss and gradients equals JAX's
    ``SVCTask.train_step`` from the same params, batch and draws: the loss
    within rtol 1e-5, the grad norm within 1e-4 and the params after the
    step within rtol 1e-4 / atol 1e-6 (tests/test_seq_parallel.py's limits;
    the params where the gradient's sign is settled, and all within 2 lr,
    as tests/test_torch_parallel.py holds them).  l1 with padded frames
    (``nonpadding``) and a ragged batch of 3 real rows over d = 2 and 4;
    against JAX without a mesh and on the conftest's (4, 2) mesh (the
    FS2-full test below holds the window sum's grads per tensor)."""
    loss_type, real, grid, mesh = CASES[case]
    hp = _hp(diff_loss_type=loss_type)
    batch = _batch(real=real)
    jt = JTask(hp, mesh=None if mesh is None else _mesh(*mesh))
    state = _jax_state(jt)
    task = _port(hp, state["params"], dist.Grid(*grid))
    p0 = {k: v.clone() for k, v in task.model.state_dict().items()}
    _, t, noise = _jax_draws(batch)
    new_state, mj = jt.train_step(state, batch, jax.random.PRNGKey(0))
    loss, grads = window_sum(task, batch, t, noise)
    task.apply_grads(grads)
    np.testing.assert_allclose(float(loss), float(mj["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(mj["grad_norm"]), rtol=1e-4)
    want_p = diffusion_jax_to_torch(jax.tree.map(np.asarray,
                                                 new_state["params"]))
    got_p = task.model.state_dict()
    for name, g in zip(task.names, grads):
        upd = (got_p[name] - p0[name]).numpy()
        upd_ref = (want_p[name] - p0[name]).numpy()
        assert np.abs(upd - upd_ref).max() <= 2 * hp["lr"] + 1e-6, name
        settled = np.abs(g.numpy()) > 1e-3 * np.abs(g.numpy()).max()
        np.testing.assert_allclose(got_p[name].numpy()[settled],
                                   want_p[name].numpy()[settled],
                                   rtol=1e-4, atol=1e-6, err_msg=name)


@pytest.fixture(scope="module")
def unsharded():
    """The unsharded port step's loss and grads (l1, a ragged batch), and
    the task whose (2, 2) grid its window sums are held against it."""
    hp = _hp(diff_loss_type="l1")
    batch = _batch(real=3)
    state = _jax_state(JTask(hp))
    task = _port(hp, state["params"], dist.Grid(2, 2))
    _, t, noise = _jax_draws(batch)
    whole = SVCTask(hp, device="cpu", grid=dist.Grid(1, 1))
    whole.model.load_state_dict(task.model.state_dict())
    return task, batch, t, noise, whole.loss_and_grads(batch, t=t,
                                                       noise=noise)


def _halo_short(monkeypatch):
    real = dist.halo
    monkeypatch.setattr(dist, "halo", lambda net, t: real(net, t) - 1)


def _halo_in_loss(monkeypatch):
    real = GaussianDiffusion.training_loss

    def counted(self, batch, **kw):
        kw["own"] = torch.ones_like(kw["own"])
        return real(self, batch, **kw)

    monkeypatch.setattr(GaussianDiffusion, "training_loss", counted)


@pytest.mark.parametrize("fault", [None, _halo_short, _halo_in_loss],
                         ids=["exact", "halo_minus_1", "halo_in_loss"])
def test_window_sum_equals_the_unsharded_step(unsharded, monkeypatch, fault):
    """The (2, 2) window sum against the unsharded port step: loss and
    grads within ``SEQ_TOL`` (rel-L2); each planted fault, a halo of
    H - 1 or the halo frames counted in the loss, fails that limit."""
    task, batch, t, noise, (l0, g0) = unsharded
    if fault is not None:
        fault(monkeypatch)
    loss, grads = window_sum(task, batch, t, noise)
    err = max(_rel(grads, g0), abs(float(loss - l0)) / abs(float(l0)))
    assert (err <= SEQ_TOL) == (fault is None), err


# ------------------------------------------- FS2-full, FFT denoiser, route --

def test_fs2_full_window_sum_matches_jax_and_blocks_share_dropout():
    """FS2-full (``no_fs2: false``): at dropout 0 the (2, 2) window sum
    equals JAX's step (loss rtol 1e-5, grads within 1e-3 of each tensor's
    largest); at dropout 0.1 the two seq ranks of a data block run the same
    encoder bit for bit, and the two blocks draw different masks."""
    hp = _hp(no_fs2=False, diff_loss_type="l1")
    batch = _batch(real=3)
    jt = JTask(hp)
    state = _jax_state(jt)
    rng, t, noise = _jax_draws(batch)
    jb = {k: jnp.asarray(v) for k, v in jt.prepare_batch(batch).items()}
    lj, gj = jax.value_and_grad(
        lambda p: jt.model.training_loss(p, jb, rng)[0])(state["params"])
    gj = diffusion_jax_to_torch(jax.tree.map(np.asarray, gj))
    task = _port(hp, state["params"], dist.Grid(2, 2))
    loss, grads = window_sum(task, batch, t, noise)
    np.testing.assert_allclose(float(loss), float(lj), rtol=1e-5)
    reached = 0
    for name, g in zip(task.names, grads):
        ref = gj[name].numpy()
        assert np.abs(g.numpy() - ref).max() <= \
            1e-3 * np.abs(ref).max() + 1e-12, name
        reached += name.startswith("fs2.encoder") and bool(ref.any())
    assert reached > 4

    twice = _batch()
    for v in twice.values():
        v[2:] = v[:2]       # block 1 holds block 0's rows
    seen = []
    for rate in (0.1, 0.0):
        task = _port(_hp(no_fs2=False, dropout=rate), state["params"],
                     dist.Grid(2, 2))
        task.model.fs2.encoder.register_forward_hook(
            lambda m, a, out: seen.append(out.detach().clone()))
        window_sum(task, twice, t, noise)  # cells (0,0) (0,1) (1,0) (1,1)
    assert torch.equal(seen[0], seen[1]) and torch.equal(seen[2], seen[3])
    assert not torch.equal(seen[0], seen[2])      # a draw per data block
    assert torch.equal(seen[4], seen[6]) and not torch.equal(seen[0],
                                                             seen[4])


def test_fft_denoiser_window_sum_equals_the_unsharded_step():
    """The FFT denoiser attends over the whole clip, so its window is the
    whole T: the (2, 2) sum of the own frames' shares equals the unsharded
    port step within ``SEQ_TOL``."""
    hp = _hp(diff_decoder_type="fft")
    batch = _batch(real=3)
    task = SVCTask(hp, device="cpu", grid=dist.Grid(2, 2))
    whole = SVCTask(hp, device="cpu", grid=dist.Grid(1, 1))
    whole.model.load_state_dict(task.model.state_dict())
    _, t, noise = _jax_draws(batch)
    l0, g0 = whole.loss_and_grads(batch, t=t, noise=noise)
    loss, grads = window_sum(task, batch, t, noise)
    assert abs(float(loss - l0)) / abs(float(l0)) <= SEQ_TOL
    assert _rel(grads, g0) <= SEQ_TOL


def test_seq_axis_takes_the_scan_route(monkeypatch):
    """Under s > 1 every ``train_route`` is "scan" (K4 at the f32 stream),
    whatever the stream and batch, as JAX's ``want`` is False on a
    seq-sharded mesh: a bf16 K4 batch and a K5-sized batch alike.  At
    s = 1 the route stays the shape's."""
    assert diffnet.train_route(20, 4, 1024, 256, 24, "bf16") == "batched"
    assert diffnet.train_route(20, 4, 1024, 256, 48, "bf16") == "per_sample"
    for b in (24, 48):
        assert diffnet.train_route(20, 4, 1024, 256, b, "bf16", 2) == "scan"
    seen = []
    real = diffnet.train_route
    monkeypatch.setattr(diffnet, "train_route",
                        lambda *a: seen.append(real(*a)) or seen[-1])
    hp = _hp(residual_channels=128, diffnet_train_stream_dtype="bf16")
    batch = _batch(t_mel=256, t_ph=128)
    SVCTask(hp, device="cpu", grid=dist.Grid(1, 2)).loss_and_grads(
        batch, frames=slice(0, 128))
    SVCTask(hp, device="cpu").loss_and_grads(batch)
    assert seen == ["scan", "batched"]


# ------------------------------------------------- pe task, trainer, remat --

PE_HP = dict(TINY_HP, lr=1e-3, scheduler="step_lr", decay_steps=100,
             optimizer_adam_beta1=0.9, optimizer_adam_beta2=0.98,
             weight_decay=0.0, clip_grad_norm=1, pitch_type="frame",
             pitch_extractor_conv_layers=2, seed=5,
             mesh_axes="data,seq", mesh_shape=[2, 2])


def test_pe_task_on_a_2x2_grid_matches_the_jax_mesh_step(monkeypatch):
    """The pe task's shares summed over the four ranks of a (2, 2) grid
    equal JAX's pe step on a (2, 2) mesh (replicated over seq): the loss
    within rtol 1e-4, the grad norm within 1e-4 and the params after the
    update within 2 lr (1e-6 where the gradient's sign is settled), as
    tests/test_torch_parallel.py holds the pe step on two ranks; no block
    counts twice, and the seq ranks past the first add zeros."""
    hp = HParams(PE_HP)
    monkeypatch.setattr(dist, "world_size", lambda: 4)
    task = PitchExtractionTask(hp, device="cpu")
    assert task.grid == dist.Grid(2, 2)
    sd = {k: v.detach().clone() for k, v in task.model.state_dict().items()}
    rng = np.random.RandomState(1)
    mels = (rng.randn(4, 40, 16) * 0.5 - 2.5).astype(np.float32)
    mels[1, 30:] = 0.0
    mels[3] = 0.0
    batch = {"mels": mels,
             "f0": (7.6 + 0.2 * rng.randn(4, 40)).astype(np.float32),
             "uv": (rng.rand(4, 40) < 0.25).astype(np.float32),
             "sample_mask": np.array([1, 1, 1, 0], np.float32)}
    loss, grads = 0.0, None
    for r in range(4):
        monkeypatch.setattr(dist, "rank", lambda r=r: r)
        lo, _, g = task.loss_and_grads(batch)
        if r % 2:
            assert float(lo) == 0.0 and not any(x.any() for x in g)
        loss = loss + lo
        grads = g if grads is None else [a + b for a, b in zip(grads, g)]
    jt = jpe_task.PitchExtractionTask(hp, mesh=_mesh(2, 2))
    params = jpe.convert({k: v.numpy() for k, v in sd.items()})
    state = {"params": params, "opt_state": jt.tx.init(params),
             "step": jnp.zeros((), jnp.int32)}
    new_state, mj = jt.train_step(state, batch, jax.random.PRNGKey(0))
    np.testing.assert_allclose(float(loss), float(mj["loss"]), rtol=1e-4)
    np.testing.assert_allclose(float(global_norm(grads)),
                               float(mj["grad_norm"]), rtol=1e-4)
    task.apply_grads(grads)
    got = jpe.convert({k: v.numpy() for k, v in
                       task.model.state_dict().items()})
    g_tree = jpe.convert(dict({k: v.numpy() for k, v in sd.items()},
                              **{n: g.numpy() for n, g in
                                 zip(task.names, grads)}))
    for a, b, z, g in zip(jax.tree.leaves(got),
                          jax.tree.leaves(new_state["params"]),
                          jax.tree.leaves(params), jax.tree.leaves(g_tree)):
        upd, ref = np.asarray(a) - np.asarray(z), np.asarray(b) - np.asarray(z)
        assert np.abs(upd - ref).max() <= 2 * hp["lr"] + 1e-6
        settled = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(upd[settled], ref[settled], atol=1e-6)


class _Items:
    """A stand-in training split: 13 items of varied lengths, collated to
    their ids (the trainer's batching, not the features, is under test)."""

    def __init__(self, prefix, hp, shuffle=False):
        self.sizes = [40 + 7 * i % 50 for i in range(13)]

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, i):
        return {"id": i}

    def num_tokens(self, i):
        return self.sizes[i]

    def ordered_indices(self, rng=None):
        return rng.permutation(len(self.sizes))

    def collater(self, samples, pad_multiple=1):
        n = len(samples)
        return {"id": np.array([s["id"] for s in samples]), "nsamples": n,
                "mels": np.zeros((n, 4, 2), np.float32)}


def _trainer_batches(monkeypatch, tmp_path, world, **mesh):
    """The global batches (item ids, padded rows as -1) a rank's Trainer
    steps on over 5 steps at ``world`` ranks."""
    monkeypatch.setattr(dist, "world_size", lambda: world)
    monkeypatch.setattr(trainer_mod, "FastSpeechDataset", _Items)
    hp = HParams(_hp(max_sentences=2, max_tokens=100000, log_interval=100,
                     val_check_interval=100, num_sanity_val_steps=0,
                     work_dir=str(tmp_path / f"w{world}"), **mesh))
    tr = trainer_mod.Trainer(hp, device="cpu", log_writer=False)
    seen = []
    tr.task.train_step = lambda b: seen.append(
        np.where(b["sample_mask"] > 0, b["id"], -1)) or {}
    tr.task.val_step = lambda b: 0.0
    tr.fit(max_steps=5)
    return [s.tolist() for s in seen]


def test_trainer_batches_for_the_data_axis(monkeypatch, tmp_path):
    """A (2, 2) grid's Trainer steps on the batches of a data-only run at
    d = 2 (``num_replicas`` and the batch padding from the data axis, as
    JAX's ``data_parallel_world_size``), not on those of d = 4, which the
    port used before (the whole world)."""
    grid = _trainer_batches(monkeypatch, tmp_path, 4, mesh_axes="data,seq",
                            mesh_shape=[2, 2])
    d2 = _trainer_batches(monkeypatch, tmp_path, 2)
    d4 = _trainer_batches(monkeypatch, tmp_path, 4)
    assert grid == d2 and len(grid) == 5
    assert grid != d4
    assert all(len(b) % 2 == 0 for b in grid)


def test_use_remat_changes_no_number():
    """``use_remat: true`` gives JAX's ``use_remat=True`` loss and grads
    (tests/test_remat_sharded_infer.py's limits: rtol 1e-6 / rtol 1e-5,
    atol 1e-7) from the same params and draws, and the port's numbers
    without it bit for bit: every port route already saves only each
    layer's input and recomputes the gates."""
    batch = _batch(b=2)
    batch.pop("sample_mask")
    key = jax.random.PRNGKey(0)
    jm = JDiffusion(_hp(use_remat=True))
    params = jm.init_params(jax.random.PRNGKey(0))
    op = params["denoise_fn"]["output_projection"]
    op["w"] = jnp.asarray(np.random.RandomState(3).randn(
        *op["w"].shape).astype(np.float32) * 0.2)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    lj, gj = jax.value_and_grad(
        lambda p: jm.training_loss(p, jb, key)[0])(params)
    gj = diffusion_jax_to_torch(jax.tree.map(np.asarray, gj))
    t_rng, n_rng, _ = jax.random.split(key, 3)
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (2,), 0, 20)))
    noise = torch.from_numpy(np.array(jax.random.normal(
        n_rng, batch["mels"].shape, jnp.float32)))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = []
    for remat in (True, False):
        tm = GaussianDiffusion(_hp(use_remat=remat))
        tm.load_state_dict(diffusion_jax_to_torch(
            jax.tree.map(np.asarray, params)))
        loss, _ = tm.training_loss(tb, t=t, noise=noise)
        names = [n for n, _ in tm.named_parameters()]
        grads = torch.autograd.grad(loss, list(tm.parameters()),
                                    allow_unused=True)
        out.append((loss.detach(), dict(zip(names, grads))))
    (lr_, gr), (ln, gn) = out
    np.testing.assert_allclose(float(lr_), float(lj), rtol=1e-6)
    assert torch.equal(lr_, ln)
    for name, g in gr.items():
        ref = gj[name].numpy()
        got = np.zeros_like(ref) if g is None else g.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7,
                                   err_msg=name)
        assert (g is None and gn[name] is None) or torch.equal(g, gn[name])


# ------------------------------------------------------ four gloo ranks --

def test_four_gloo_ranks_on_a_2x2_grid(tmp_path):
    """Four gloo ranks laid out by ``mesh_axes: data,seq``, ``mesh_shape:
    [2, 2]``, two steps on a ragged batch (3 real rows of 4): each step's
    all-reduced grads equal the one-process window sum (``SEQ_TOL``), the
    loss within 1e-6, every rank's route decided on its 2 rows, and the
    four ranks' params equal bit for bit."""
    hp = _hp(diff_loss_type="l1", mesh_axes="data,seq", mesh_shape=[2, 2])
    batch = _batch(real=3)
    state = _jax_state(JTask(_hp()))
    ref = _port(hp, state["params"], dist.Grid(2, 2))
    sd = {k: v.clone() for k, v in ref.model.state_dict().items()}
    draws = [_jax_draws(batch, step)[1:] for step in range(2)]
    args_path = str(tmp_path / "args.pt")
    torch.save({"hp": dict(hp), "sd": sd, "batch": batch, "draws": draws},
               args_path)
    out = tmp_path / "out"
    out.mkdir()
    mp.spawn(_torch_dist_worker.run,
             args=(4, str(tmp_path / "store"), "svc_steps", args_path,
                   str(out)), nprocs=4, join=True)
    ranks = [torch.load(str(out / f"rank{r}.pt"), weights_only=False)
             for r in range(4)]
    for i, (t, noise) in enumerate(draws):
        loss, grads = window_sum(ref, batch, t, noise)
        ref.apply_grads(grads)
        got = ranks[0]["steps"][i]
        assert _rel(got["grads"], grads) <= SEQ_TOL
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-6)
        for r in ranks[1:]:
            for k, v in got["params"].items():
                assert torch.equal(v, r["steps"][i]["params"][k]), k
    for r in ranks:
        assert r["routes"] and set(r["routes"]) == {2}
