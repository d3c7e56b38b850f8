"""The vocoder's learned-quality tools and the train-stream A/B of the port
(``diffsvc_tpu_torch/tools/train_istft.py``, ``ab_vocoder.py``,
``ab_train_stream.py``) against the JAX tools and package on the CPU, at
tiny widths: the clips, the held-out render and its scores for both
vocoder families, the A/B's batches and its three legs, each tool end to
end, and the ``diffnet_pallas_train: off`` repair.

The JAX tools keep their helpers inside ``main`` (the A/B's
``make_batch``, the vocoder A/B's ``render``); they are lifted out of the
tool's source with ``ast`` and run as the tool runs them, so the port is
held to the JAX tool's own code.

The GAN tests run MPD and MSD at ``tests/test_torch_vocoder_task.py``'s
small widths (its ``small_discs``): the generators and the renders are
what is held here.

Tolerances: the clips' wav bit for bit, the mel 1e-5 and the f0 equal
(a recording's mel within 1e-4 and the AC tracker's f0 within 1e-4 Hz,
the front end's tolerances in ``tests/test_torch_frontend.py``); the renders and their
scores 1e-4 relative; the A/B legs (the bf16 one too) and the repaired
step at ``tests/test_torch_training.py``'s tolerances (loss 1e-5
relative, grad norm and grads 1e-3).
"""

import ast
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_vocoder import _jax_randoms
from test_torch_vocoder_task import small_discs  # noqa: F401 (a fixture)
from diffsvc_tpu.config import HParams as JHParams
from diffsvc_tpu.ops.stft_loss import multi_resolution_stft_loss as j_mrstft
from diffsvc_tpu.training.task import SVCTask as JTask
from diffsvc_tpu.training.vocoder_task import VocoderTask as JVocoderTask
from diffsvc_tpu.utils import convert_torch as jcvt
from diffsvc_tpu_torch.config import HParams
from diffsvc_tpu_torch.tools import ab_train_stream as ts
from diffsvc_tpu_torch.tools import ab_vocoder as av
from diffsvc_tpu_torch.tools import train_istft as ti
from diffsvc_tpu_torch.training.task import SVCTask
from diffsvc_tpu_torch.training.vocoder_task import VocoderTask
from diffsvc_tpu_torch.utils.convert import diffusion_jax_to_torch
from diffsvc_tpu_torch.vocoders import istft_head as tih

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--tiny", "--device", "cpu"]
# the tiny profile's clip features (sr, dur, hop, n_mel, n_fft, win,
# fmin, fmax)
SR, DUR, HOP, NMEL, NFFT, WIN, FMIN, FMAX = 8000, 1.0, 64, 16, 256, 256, \
    40.0, 3500.0
LEG_STEPS = 2
TOL = {"loss": 1e-5, "grad": 1e-3}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for this module: under xdist its many
    small products on a pool of threads per worker oversubscribe the cores
    (the end-to-end tests took 176-245 s each on six workers, against 1-5
    s alone), as ``tests/test_torch_learn.py`` found."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_source(name):
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        return ast.parse(f.read())


def _jax_tool(name):
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nested_fn(tool, fn_name, **namespace):
    """The function ``fn_name`` defined inside the JAX tool's ``main``,
    compiled on its own with ``namespace`` for its free names."""
    fn = next(n for n in ast.walk(_jax_source(tool))
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    code = compile(ast.Module(body=[fn], type_ignores=[]), tool, "exec")
    exec(code, namespace)
    return namespace[fn_name]


def _dict_keys(tool, var):
    """The keys of the dict literal the JAX tool assigns to ``var``."""
    for n in ast.walk(_jax_source(tool)):
        if (isinstance(n, ast.Assign) and isinstance(n.value, ast.Dict)
                and getattr(n.targets[0], "id", "") == var):
            return {k.value for k in n.value.keys}
    raise KeyError(var)


def _returned_keys(tool, fn_name):
    fn = next(n for n in ast.walk(_jax_source(tool))
              if isinstance(n, ast.FunctionDef) and n.name == fn_name)
    ret = next(n for n in ast.walk(fn) if isinstance(n, ast.Return)
               and isinstance(n.value, ast.Dict))
    return {k.value for k in ret.value.keys}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


# ---------------------------------------------------------------------------
# the data
# ---------------------------------------------------------------------------

def test_make_clips_equal_the_jax_tools():
    """``train_istft.make_clips`` against ``tools/train_istft_tpu.py``'s:
    the wav bit for bit, the mel within 1e-5, the f0 equal."""
    jax_tool = _jax_tool("train_istft_tpu")
    want = jax_tool.make_clips(SR, 3, 0.5, HOP, NMEL, NFFT, WIN, FMIN, FMAX)
    got = ti.make_clips(SR, 3, 0.5, HOP, NMEL, NFFT, WIN, FMIN, FMAX)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["wav"], w["wav"])
        assert g["mel"].shape == w["mel"].shape
        np.testing.assert_allclose(g["mel"], w["mel"], atol=1e-5, rtol=0)
        np.testing.assert_array_equal(g["f0"], w["f0"])


def test_make_real_clips_equal_the_jax_tools(tmp_path):
    """``ab_vocoder.make_real_clips`` on a 22.05 kHz int16 recording of
    2.2 s: resampled to 8 kHz, two 1 s windows, the wav bit for bit, the
    mel and the AC tracker's f0 at the front end's tolerances (1e-4
    relative and absolute, 1e-4 Hz: the resampled wav's mel is 1.1e-5 off
    JAX's at a magnitude of 3.3)."""
    from scipy.io import wavfile

    from diffsvc_tpu_torch.utils import synth

    rec = str(tmp_path / "rec.wav")
    wav = synth.voiced_wav(2.2, 22050, f0=196.0, gaps=[(0.9, 1.2)])
    wavfile.write(rec, 22050, (wav * 32767).astype(np.int16))
    want = _jax_tool("ab_vocoder_tpu").make_real_clips(
        rec, SR, DUR, HOP, NMEL, NFFT, WIN, FMIN, FMAX)
    got = av.make_real_clips(rec, SR, DUR, HOP, NMEL, NFFT, WIN, FMIN, FMAX)
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g["wav"], w["wav"])
        np.testing.assert_allclose(g["mel"], w["mel"], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(g["f0"], w["f0"], atol=1e-4, rtol=0)
        assert (g["f0"] > 0).any() and (g["f0"] == 0).any()


def test_make_batch_equals_the_jax_tools():
    """``ab_train_stream.make_batch`` against the JAX tool's (nested in its
    ``main``) at the tiny dims: every array equal."""
    d = ts.dims(ts.parse_args(TINY))
    t_ph = d["T"] * 128 // 320
    jax_make = _nested_fn("ab_train_stream", "make_batch", np=np, jnp=jnp,
                          B=d["B"], T=d["T"], n_mel=d["n_mel"], H=d["H"],
                          t_ph=t_ph)
    for i in range(2):
        want, got = jax_make(i), ts.make_batch(d, i)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], np.asarray(want[k]),
                                          err_msg=k)


# ---------------------------------------------------------------------------
# the held-out render and its scores, both families
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("family", ["nsf", "istft"])
def test_held_out_render_matches_jax(small_discs, family):
    """The JAX tool's ``render`` (nested in ``run_family``) on the port
    generator's weights, converted, and the port's ``train_istft.render``:
    the mel-L1, the multi-resolution STFT loss and the wav within 1e-4
    relative; the NSF source from JAX's ``PRNGKey(7)`` draws."""
    hp = av.family_hp(av.profile(True), family)
    task = VocoderTask(hp, device="cpu")
    with torch.no_grad():                   # a trained-looking generator
        for p in task.gen.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator()
                               .manual_seed(p.numel())) * 0.02)
    jtask = JVocoderTask(JHParams(**dict(hp)))
    held = ti.make_clips(SR, 1, DUR, HOP, NMEL, NFFT, WIN, FMIN, FMAX)[0]
    if family == "istft":
        params = jax.tree.map(jnp.asarray, tih.jax_tree(task.gen))
        randoms = None
    else:
        sd = {k: v.numpy() for k, v in task.gen.state_dict().items()}
        params = jcvt.convert_hifigan_generator(sd, jtask.cfg)
        randoms = _jax_randoms(jax.random.PRNGKey(7), 1,
                               held["mel"].shape[0] * HOP,
                               task.cfg.harmonic_num)
    jrender = _nested_fn("ab_vocoder_tpu", "render", held_out=held,
                         task=jtask, jnp=jnp, jax=jax,
                         multi_resolution_stft_loss=j_mrstft)
    l1_j, stft_j, wav_j = jax.jit(jrender)(params)
    l1, mr, wav = ti.render(task, held, randoms)
    assert abs(l1 - float(l1_j)) <= 1e-4 * abs(float(l1_j)), (l1, l1_j)
    assert abs(mr - float(stft_j)) <= 1e-4 * abs(float(stft_j)), (mr, stft_j)
    assert wav.shape == wav_j.shape and _rel(wav, wav_j) <= 1e-4


# ---------------------------------------------------------------------------
# the A/B's legs, and the diffnet_pallas_train repair
# ---------------------------------------------------------------------------

def _leg_hp(d, extra):
    return dict(ts.base_hp(d), **extra)


def _jax_leg_extra(name):
    """The JAX tool's leg hparams on the CPU (``:120-127``)."""
    return {"batched_bf16": dict(diffnet_pallas_train="interpret",
                                 diffnet_train_stream_dtype="bf16"),
            "kernel_f32": dict(diffnet_pallas_train="interpret",
                               diffnet_train_stream_dtype="f32"),
            "scan": dict(diffnet_pallas_train="off")}[name]


def _jax_draws(d, k_step, batch, step):
    """t and noise as the JAX tool's step ``step`` draws them
    (``PRNGKey(step)`` folded with the state's step)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(step), step)
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (d["B"],), 0, k_step)
    noise = jax.random.normal(n_rng, batch["mels"].shape, jnp.float32)
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


@pytest.fixture(scope="module")
def tiny_dims():
    return dict(ts.dims(ts.parse_args(TINY)), steps=LEG_STEPS)


@pytest.fixture(scope="module")
def jax_params(tiny_dims):
    """JAX's initial params of the A/B's model, as host arrays: every leg
    starts from them (a JAX step donates its state's buffers)."""
    hp = ts.base_hp(tiny_dims)
    jt = JTask(JHParams(**hp))
    # JAX's init, jitted (eager it takes seconds; its values differ from
    # init_state's in the last bits, and every leg starts from these)
    params = jax.jit(jt.model.init_params)(jax.random.PRNGKey(hp["seed"]))
    return jax.tree.map(np.asarray, params)


def _jax_state(jt, params):
    params = jax.tree.map(jnp.asarray, params)
    return {"params": params, "opt_state": jt.tx.init(params),
            "step": jnp.zeros((), jnp.int32)}


@pytest.mark.parametrize("leg", [name for name, _ in ts.LEGS])
def test_ab_legs_match_jax(tiny_dims, jax_params, leg):
    """Each leg for two steps from JAX's initial state on the same
    batches and draws: the port's leg (the route rule's pick on the CPU:
    the plain versions) against the JAX tool's (``interpret`` for the
    kernel legs, ``off`` for the scan), loss by loss."""
    d = tiny_dims
    extra = dict(ts.LEGS)[leg]
    jt = JTask(JHParams(**_leg_hp(d, _jax_leg_extra(leg))))
    state = _jax_state(jt, jax_params)
    tt = SVCTask(HParams(_leg_hp(d, extra)), device="cpu")
    tt.model.load_state_dict(diffusion_jax_to_torch(
        jax.tree.map(np.asarray, state["params"])))
    assert ts.leg_route(tt.hp, d) == ("scan" if leg == "scan" else "batched")
    for s in range(LEG_STEPS):
        batch = ts.make_batch(d, s % ts.N_BATCHES)
        state, mj = jt.train_step(state, {k: jnp.asarray(v) for k, v in
                                          batch.items()},
                                  jax.random.PRNGKey(s))
        t, noise = _jax_draws(d, jt.model.cfg.K_step, batch, s)
        mt = tt.train_step(batch, t=t, noise=noise)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=TOL["loss"],
                                   err_msg=f"{leg} step {s}")


def test_pallas_train_off_trains_the_f32_scan(jax_params):
    """Repair: ``diffnet_pallas_train: off`` with the bf16 stream (the
    A/B's scan leg) trains through JAX's f32 scan; the port read no such
    hparam and streamed bf16 through K4 at a kernel-eligible shape (C=128,
    T=256).  One step from the same params (a nonzero output head, so the
    denoiser's inner grads are nonzero), batch, t and noise: the loss,
    the grad norm and every gradient at the f32 tolerances."""
    from test_torch_training import _torch_sd

    d = dict(ts.dims(ts.parse_args(TINY)), steps=1)
    hp = _leg_hp(d, dict(diffnet_pallas_train="off",
                         diffnet_train_stream_dtype="bf16"))
    jt = JTask(JHParams(**hp))
    state = _jax_state(jt, jax_params)
    op = state["params"]["denoise_fn"]["output_projection"]
    op["w"] = jnp.asarray(np.random.RandomState(3).randn(
        *op["w"].shape).astype(np.float32) * 0.2)
    tt = SVCTask(HParams(hp), device="cpu")
    tt.model.load_state_dict(diffusion_jax_to_torch(
        jax.tree.map(np.asarray, state["params"])))
    assert ts.leg_route(tt.hp, d) == "scan"
    batch = ts.make_batch(d, 0)
    jb = jt.prepare_batch({k: jnp.asarray(v) for k, v in batch.items()})
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 0)
    lj, gj = jax.jit(jax.value_and_grad(
        lambda p: jt.model.training_loss(p, jb, rng)[0]))(state["params"])
    t, noise = _jax_draws(d, jt.model.cfg.K_step, batch, 0)
    loss, _ = tt.model.training_loss(tt.prepare_batch(batch), t=t,
                                     noise=noise)
    gt = torch.autograd.grad(loss, tt.params, allow_unused=True)
    mt = tt.train_step(batch, t=t, noise=noise)
    np.testing.assert_allclose(float(mt["loss"]), float(lj),
                               rtol=TOL["loss"])
    np.testing.assert_allclose(float(mt["grad_norm"]),
                               float(optax.global_norm(gj)), rtol=TOL["grad"])
    want = _torch_sd(gj)
    for name, g in zip(tt.names, gt):
        ref = want[name]
        g = np.zeros_like(ref) if g is None else g.numpy()
        assert np.abs(g - ref).max() <= TOL["grad"] * np.abs(
            ref).max() + 1e-12, name


# ---------------------------------------------------------------------------
# each tool end to end
# ---------------------------------------------------------------------------

def _main(mod, argv, capsys):
    summary = mod.main(argv)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return summary, line


def test_train_istft_end_to_end(small_discs, tmp_path, capsys):
    """Two steps at B=1: the JAX tool's summary keys (and the card, the
    launches: none on the CPU), the wrapper reload bit for bit, the wavs
    and the checkpoint written, the JSON line."""
    out = str(tmp_path / "ti")
    summary, line = _main(ti, TINY + ["--steps", "2", "--batch", "1",
                                      "--log-interval", "1", "--out", out],
                          capsys)
    assert _dict_keys("train_istft_tpu", "summary") <= set(summary)
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == summary
    assert summary["card"] is None and summary["backend"] == "cpu"
    assert set(summary["launches"].values()) == {0}
    assert [c["step"] for c in summary["loss_curve"]] == [1, 2]
    assert summary["wrapper_reload"]["params_exact"]
    assert summary["wrapper_reload"]["render_max_abs_diff"] == 0.0
    assert summary["ok"] == line["ok"]
    assert line["l1_before"] == summary["held_out_mel_l1"]["before"]
    for fn in ("before.wav", "after.wav", "target.wav", "istft_g.npz"):
        assert os.path.isfile(os.path.join(out, fn)), fn


def test_ab_vocoder_end_to_end(small_discs, tmp_path, capsys):
    """Both families for one step at B=1 on two clips: the JAX tool's
    summary and per-family keys, finite scores, K3 not launched on the
    CPU, the files and the JSON line."""
    out = str(tmp_path / "ab")
    summary, line = _main(av, TINY + ["--steps", "1", "--batch", "1",
                                      "--n-clips", "2", "--out", out],
                          capsys)
    assert _dict_keys("ab_vocoder_tpu", "summary") <= set(summary)
    assert list(summary["results"]) == ["nsf", "istft"]
    keys = _returned_keys("ab_vocoder_tpu", "run_family")
    for name, r in summary["results"].items():
        assert keys <= set(r), name
        assert np.isfinite(list(r["held_out"].values())).all()
        assert all(v == 0 for n in r["render_launches"].values()
                   for v in n.values())
    assert line["ab"] == {k: v["held_out"]
                          for k, v in summary["results"].items()}
    for fn in ("nsf_before.wav", "nsf_after.wav", "istft_before.wav",
               "istft_after.wav", "target.wav", "nsf_g.pt", "istft_g.npz",
               "summary.json"):
        assert os.path.isfile(os.path.join(out, fn)), fn


def test_ab_train_stream_end_to_end(tmp_path, capsys):
    """The tiny A/B (8 steps, both JAX asserts held by ``main``): the JAX
    tool's result keys, each leg's route (C=128, T=256: both kernel legs
    K4's) and no launch on the CPU, the result file and the JSON line.
    ``failures`` sees a scan curve that does not fall and a bf16 curve 2%
    off the scan."""
    out = str(tmp_path / "ts")
    result, line = _main(ts, TINY + ["--out", out], capsys)
    assert _dict_keys("ab_train_stream", "result") <= set(result)
    assert result["dims"] == {"B": 2, "T": 256, "C": 128, "L": 4, "steps": 8}
    assert {n: r["route"] for n, r in result["legs"].items()} == {
        "batched_bf16": "batched", "kernel_f32": "batched", "scan": "scan"}
    for r in result["legs"].values():
        assert set(r["launches"].values()) == {0}
    assert line["gap_vs_scan"] == result["gap_vs_scan"]
    with open(os.path.join(out, "result.json")) as f:
        assert json.load(f)["curves"] == result["curves"]
    curves = result["curves"]
    assert result["failures"] == ts.failures(curves, 8) == []
    assert ts.failures(dict(curves, scan=[1.0] * 8), 8) == [
        "scan: loss did not decrease (1.00000 -> 1.00000)"]
    off = ts.failures(dict(curves, batched_bf16=[
        x * 1.02 for x in curves["batched_bf16"]]), 8)
    assert len(off) == 1 and off[0].startswith("bf16 gap"), off


# ---------------------------------------------------------------------------
# the committed artifacts (the tools at their defaults on the card)
# ---------------------------------------------------------------------------

def _artifact(*parts):
    with open(os.path.join(REPO, "runs", *parts)) as f:
        return json.load(f)


def _on_the_card(summary):
    assert summary["backend"] == "cuda"
    assert "H100" in summary["card"] and " W" in summary["card"], \
        summary["card"]


def test_istft_train_artifact():
    """``runs/torch_istft_train``: 400 steps of the head at 512 x 8 on the
    card, the JAX tool's criterion (after < 0.7 x before), the reload
    exact, no kernel launched."""
    s = _artifact("torch_istft_train", "summary.json")
    _on_the_card(s)
    assert s["steps"] == 400
    assert (s["dims"]["sr"], s["dims"]["dim"], s["dims"]["layers"]) == (
        44100, 512, 8)
    l1 = s["held_out_mel_l1"]
    assert s["ok"] and l1["after"] < 0.7 * l1["before"]
    assert s["wrapper_reload"]["ok"] and s["wrapper_reload"]["params_exact"]
    assert set(s["launches"].values()) == {0}
    for fn in ("before.wav", "after.wav", "target.wav"):
        assert os.path.isfile(os.path.join(REPO, "runs", "torch_istft_train",
                                           fn)), fn


def test_vocoder_ab_artifact():
    """``runs/torch_vocoder_ab``: 1,500 steps of both families on 16 clips
    on the card: mel-L1 and the multi-resolution STFT loss lower after
    training for each, NSF's STFT loss below the head's (as in the JAX
    tool's run), one K3 tail per NSF render and none for the head's."""
    s = _artifact("torch_vocoder_ab", "summary.json")
    _on_the_card(s)
    assert s["dims"]["clips"] == 16 and s["dims"]["sr"] == 44100
    res = s["results"]
    for name, r in res.items():
        h = r["held_out"]
        assert r["steps"] == 1500, name
        assert h["mel_l1_after"] < h["mel_l1_before"], name
        assert h["mr_stft_after"] < h["mr_stft_before"], name
    assert (res["nsf"]["held_out"]["mr_stft_after"]
            < res["istft"]["held_out"]["mr_stft_after"])
    assert [r["K3"] for r in res["nsf"]["render_launches"].values()] == [1, 1]
    assert [r["K3"] for r in res["istft"]["render_launches"].values()] == [
        0, 0]


@pytest.mark.parametrize("name", ["result.json", "result_earlier_run.json"])
def test_ab_train_stream_artifact(name):
    """``runs/torch_ab_train_stream``: two runs of 200 steps at B=24 x
    T=1024, C=384, L=20 on the card.  Each leg on its route with one
    backward a step on its counter (the bf16 stream on K4, the f32 stream
    on K5, the scan on K4 at the f32 stream); every curve falls; the
    recorded comparison and failures are the JAX tool's on the curves.  The
    bf16 gap assert held in one run and not in the other (1.91% and 1.07%
    of the scan's tail loss, against limits of 2.33% and 1%: ``ROADMAP.md``
    Queue 3), so this pins the record, not the verdict."""
    r = _artifact("torch_ab_train_stream", name)
    _on_the_card(r)
    assert r["dims"] == {"B": 24, "T": 1024, "C": 384, "L": 20, "steps": 200}
    want = {"batched_bf16": ("batched", {"K4_bwd": 200, "K4_bwd_f32": 0,
                                         "K5": 0}),
            "kernel_f32": ("per_sample", {"K4_bwd": 0, "K4_bwd_f32": 0,
                                          "K5": 200}),
            "scan": ("scan", {"K4_bwd": 200, "K4_bwd_f32": 200, "K5": 0})}
    for leg, (route, counts) in want.items():
        rec = r["legs"][leg]
        assert rec["route"] == route, leg
        assert {k: rec["launches"][k] for k in counts} == counts, leg
    cmp_ = ts.compare(r["curves"], 200)
    for key in ("tail_mean_loss", "gap_vs_scan", "bf16_rel_gap"):
        assert r[key] == cmp_[key], key
    failed = ts.failures(r["curves"], 200)
    assert not any("did not decrease" in m for m in failed)
    assert r.get("failures", failed) == failed
