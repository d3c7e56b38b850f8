"""The learned-score evidence of the port (``diffsvc_tpu_torch/tools``) on
the CPU at tiny widths: the synthetic-singing data against the JAX tool's,
the sampler grid's rows against the JAX tool's, a learned score sampled by
the port and by the JAX package from one checkpoint and one x_T, both tools
end to end, the validation plot's matplotlib repair, and the committed
artifacts' orderings (the claims ``configs/config_44k_fast.yaml`` and
``config_44k_turbo.yaml`` rest on).

The parity rows are held at the tolerance of ``tests/test_torch_diffusion.
py`` for the clipped and DPM-Solver++ samplers (3e-4 absolute, 1e-4
relative: f32 sums in another order, over 11-21 evaluations and the
reference's 403); the metrics,
means of those rows' differences, at the same relative 1e-4 plus 3e-4 over
the reference's magnitude.
"""

import ast
import contextlib
import glob
import importlib.util
import io
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.config import HParams as JHParams
from diffsvc_tpu.models import diffusion as jdiff
from diffsvc_tpu.utils.convert_torch import convert_gaussian_diffusion
from diffsvc_tpu_torch.config import HParams
from diffsvc_tpu_torch.tools import sampler_quality as sq
from diffsvc_tpu_torch.tools import train_demo as td
from diffsvc_tpu_torch.training.trainer import Trainer
from diffsvc_tpu_torch.utils import synth

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--tiny", "--device", "cpu"]
SQ = TINY + ["--n-clips", "8"]      # 3 train and 5 test items
STEPS = 4


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The plain ladders here run thousands of tiny products, which a pool
    of intra-op threads only slows (and oversubscribes under xdist)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _files(d):
    return {os.path.basename(f): open(f, "rb").read()
            for f in sorted(glob.glob(os.path.join(d, "*")))}


# ---------------------------------------------------------------------------
# (a) the data, (b) the grid's rows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["synthetic", "real"])
def test_dataset_files_equal_the_jax_tools(tmp_path, kind):
    """``synth.make_dataset`` / ``make_real_dataset`` write the JAX tool's
    ``clipNN.wav`` and ``clipNN.npy`` byte for byte (sr 8,000, 0.5 s)."""
    jax_tool = _jax_tool("train_demo_tpu")
    if kind == "synthetic":
        jax_tool.make_dataset(str(tmp_path / "jax"), sr=8000, n_clips=2,
                              dur=0.5)
        synth.make_dataset(str(tmp_path / "port"), sr=8000, n_clips=2,
                           dur=0.5)
    else:
        # a 22.05 kHz int16 recording of 1.3 s: resampled, two windows
        from scipy.io import wavfile

        rec = str(tmp_path / "rec.wav")
        wav = synth.voiced_wav(1.3, 22050, seed=3)
        wavfile.write(rec, 22050, (wav * 32767).astype(np.int16))
        n_jax = jax_tool.make_real_dataset(str(tmp_path / "jax"), rec,
                                           sr=8000, dur=0.5)
        n_port = synth.make_real_dataset(str(tmp_path / "port"), rec,
                                         sr=8000, dur=0.5)
        assert n_jax == n_port == 2
    want, got = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(got) == ["clip00.npy", "clip00.wav", "clip01.npy",
                           "clip01.wav"]
    assert got == want


def test_rows_names_and_nfe_equal_the_jax_tools():
    """The rows (``configs`` of ``tools/sampler_quality.py``), their names
    and NFE equal the JAX tool's, as its production artifact lists them."""
    tree = ast.parse(open(os.path.join(REPO, "tools",
                                       "sampler_quality.py")).read())
    configs = next(ast.literal_eval(n.value) for n in ast.walk(tree)
                   if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", "") == "configs")
    assert [tuple(r) for r in configs] == sq.ROWS
    with open(os.path.join(REPO, "runs", "sampler_quality",
                           "summary_5000steps_64clips.json")) as f:
        jax_rows = json.load(f)["samplers"]
    got = {sq.row_name(*r): sq.row_nfe(1000, r[1]) for r in sq.ROWS}
    assert got == {k: v["nfe"] for k, v in jax_rows.items()}


# ---------------------------------------------------------------------------
# (c) a learned score, sampled by the port and by JAX; (d) end to end
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """The sampler tool's data and training, a few steps at tiny widths on
    the CPU: (its scratch with the binarized data and work dir, the
    resolved hparams)."""
    scratch = str(tmp_path_factory.mktemp("sq_scratch"))
    args = sq.parse_args(SQ + ["--steps", str(STEPS), "--out", scratch])
    with contextlib.redirect_stdout(io.StringIO()):
        hp, _ = sq.prepare(args, scratch, torch.device("cpu"))
    return scratch, hp


PARITY_ROWS = [("dpmpp", 100, "lambda", 1.0), ("plms", 100, "lambda", 1.0),
               ("dpmpp", 50, "t", 0.0), ("dpmpp", 100, "lambda", 0.0)]


def test_learned_score_rows_match_jax(trained):
    """The port's checkpoint read by the JAX package's own loader
    (``convert_torch.convert_gaussian_diffusion``); from the same held-out
    batch and x_T, ``GaussianDiffusion.infer`` of both packages gives the
    same mel for four cheap rows and the reference, and the same
    metrics."""
    scratch, hp = trained
    model, step = sq.restore_model(hp, "cpu")
    assert step == STEPS
    jb, mask, gt = sq.held_out(hp, "cpu")
    b, t_mel = jb["mel2ph"].shape
    x_T = sq.shared_x_T(b, t_mel, int(hp["audio_num_mel_bins"]))
    jhp = JHParams(**dict(hp))
    params = convert_gaussian_diffusion(os.path.join(scratch, "work"), jhp)
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in jb.items()}

    def jax_row(sampler, acc, grid="lambda", clip=0.0):
        m = jdiff.GaussianDiffusion(JHParams(**dict(
            hp, sampler=sampler, dpmpp_grid=grid, sampler_clip_x0=clip)))
        return np.asarray(m.infer(params, jbatch, jax.random.PRNGKey(3),
                                  speedup=acc,
                                  init_noise=jnp.asarray(x_T.numpy()))
                          ["mel_out"])

    nmel = int(hp["audio_num_mel_bins"])
    ref_port = sq.sample(model, hp, jb, x_T, *sq.REFERENCE)
    ref_jax = jax_row(*sq.REFERENCE)
    np.testing.assert_allclose(ref_port, ref_jax, atol=3e-4, rtol=1e-4)
    scale = float(np.abs(ref_jax).mean())
    for row in PARITY_ROWS:
        port = sq.sample(model, hp, jb, x_T, *row)
        ref = jax_row(*row)
        assert np.isfinite(port).all() and np.abs(ref).max() > 0.1
        np.testing.assert_allclose(port, ref, atol=3e-4, rtol=1e-4,
                                   err_msg=sq.row_name(*row))
        nfe = sq.row_nfe(1000, row[1])
        got = sq.row_metrics(port, ref_port, gt, mask, nmel, nfe)
        want = sq.row_metrics(ref, ref_jax, gt, mask, nmel, nfe)
        for key in ("solver_err_l1", "gt_err_l1"):
            assert abs(got[key] - want[key]) <= 1e-4 * abs(want[key]) \
                + 3e-4 * (1 + scale), (row, key)
        assert np.allclose(got["mel_range"], want["mel_range"], atol=0.011,
                           rtol=1e-4), row


def test_sampler_tool_end_to_end(trained, tmp_path, capsys):
    """``main`` on the trained work dir (``--reuse-ckpt``): the summary's
    keys, every row finite, 14 rows' worth of ladders (none on the CPU),
    the JSON line on stdout."""
    scratch, _ = trained
    out = str(tmp_path / "out")
    summary = sq.main(SQ + ["--steps", str(STEPS), "--reuse-ckpt",
                              os.path.join(scratch, "work"), "--out", out,
                              "--compute-dtype", "bf16"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["sampler_quality"] == summary["samplers"]
    with open(os.path.join(out, "summary.json")) as f:
        assert json.load(f) == summary
    assert {"device", "backend", "card", "dims", "data", "compute_dtype",
            "train_steps", "held_out_items", "reference",
            "cross_reference_l1", "k2_launches", "samplers"} <= set(summary)
    assert summary["train_steps"] == STEPS and summary["dims"] == "tiny"
    assert summary["compute_dtype"] == "bf16" and summary["card"] is None
    assert summary["k2_launches"] == 0       # the plain ladder on the CPU
    assert list(summary["samplers"]) == [sq.row_name(*r) for r in sq.ROWS]
    for r in summary["samplers"].values():
        assert np.isfinite([r["solver_err_l1"], r["gt_err_l1"],
                            *r["mel_range"]]).all()


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The train demo at tiny widths on the CPU with neither matplotlib nor
    tensorboard importable: (args, summary, scratch, printed lines)."""
    scratch = str(tmp_path_factory.mktemp("demo_scratch"))
    args = td.parse_args(TINY + ["--steps", str(STEPS), "--resume-steps",
                                 "2", "--val-interval", "2", "--out",
                                 os.path.join(scratch, "out")])
    printed = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        for mod in ("matplotlib", "matplotlib.figure",
                    "torch.utils.tensorboard"):
            mp.setitem(sys.modules, mod, None)
        with contextlib.redirect_stdout(printed):
            summary = td.run(args, scratch)
    return args, summary, scratch, printed.getvalue()


def test_train_demo_end_to_end(demo, capsys):
    """Fit, resume to steps + resume steps, the summary's keys, a
    validation wav vocoded at every validation; ``report`` writes the
    summary and prints the JSON line."""
    args, summary, scratch, _ = demo
    assert summary["phase1"]["steps"] == STEPS
    assert summary["resume"] == dict(summary["resume"], from_step=STEPS,
                                     to_step=STEPS + 2)
    assert summary["checkpoints"][-1] == f"model_ckpt_steps_{STEPS + 2}.ckpt"
    assert {"device", "backend", "card", "dims", "batch", "train_route",
            "phase1", "resume", "checkpoints", "scalar_tags",
            "tr_loss_curve", "val_loss_curve", "tb_artifacts",
            "validation_wav"} <= set(summary)
    assert summary["train_route"] == "scan"      # C=32: no kernel route
    for fit in ("phase1", "resume"):
        assert summary[fit]["launches"] == {"K2": 0, "K3": 0, "K4": 0,
                                            "K5": 0}
    assert [s for s, _ in summary["val_loss_curve"]] == [2, 4, 4, 6, 6]
    wav = summary["validation_wav"]
    assert wav["step"] == STEPS + 2 and wav["finite"]
    assert wav["samples"] > 0 and wav["rms"] > 0
    td.report(args, summary, scratch)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["steps"] == STEPS + 2 and line["metric"] == "torch_train_demo"
    with open(os.path.join(args.out, "summary.json")) as f:
        assert json.load(f)["resume"]["to_step"] == STEPS + 2


# ---------------------------------------------------------------------------
# (e) the validation plot without matplotlib
# ---------------------------------------------------------------------------

def test_validation_without_matplotlib_keeps_sample_and_audio(demo):
    """No figure is recorded, JAX's line is printed, and each validation
    still samples and vocodes (an audio artifact per validation)."""
    _, summary, _, printed = demo
    kinds = [a[0] for a in summary["tb_artifacts"]]
    assert kinds == ["audio"] * 5
    assert printed.count("| plot_validation skipped: ") == 5


@pytest.mark.parametrize("where", ["sample", "vocoder"])
def test_validation_errors_still_raise(demo, monkeypatch, tmp_path, where):
    """A K2 (sampling) or K3 (vocoder) failure inside ``_plot_validation``
    is not swallowed: ``fit`` raises."""
    _, summary, _, _ = demo
    hp = HParams(dict(summary["hp"], max_updates=STEPS + 3))
    for mod in ("matplotlib", "torch.utils.tensorboard"):
        monkeypatch.setitem(sys.modules, mod, None)
    trainer = Trainer(hp, log_writer=td.RecordingWriter(str(tmp_path)),
                      device="cpu")

    def broken(*a, **k):
        raise RuntimeError(f"{where} failed")

    if where == "sample":
        monkeypatch.setattr(trainer.task, "sample", broken)
    else:
        monkeypatch.setattr(trainer.vocoder, "spec2wav", broken)
    with pytest.raises(RuntimeError, match=f"{where} failed"):
        trainer.fit()


def test_tools_refuse_without_a_card(monkeypatch, tmp_path):
    """Without a card both tools raise before any work (``--device cpu``
    asks for the CPU)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for tool in (td, sq):
        with pytest.raises(RuntimeError, match="--device cpu"):
            tool.run(tool.parse_args(["--tiny", "--out", str(tmp_path)]),
                     str(tmp_path))
    assert os.listdir(tmp_path) == []


# ---------------------------------------------------------------------------
# the committed artifacts
# ---------------------------------------------------------------------------

def _artifacts():
    return sorted(glob.glob(os.path.join(
        REPO, "runs", "torch_sampler_quality*", "summary*.json")))


ARTIFACTS = _artifacts()


@pytest.mark.parametrize("path", ARTIFACTS,
                         ids=[os.path.relpath(p, REPO) for p in ARTIFACTS])
def test_artifact_orderings(path):
    """Orderings 1-4 of ``tests/test_sampler_quality_artifacts.py`` on the
    port's artifacts: DPM-Solver++ at 21 NFE tracks the converged ODE at
    least as well as PLMS at 21; dpmpp50+clip within 15% of clipped PLMS20's
    ground-truth error; every clipped DPM-Solver++ row inside [-8, 3];
    dpmpp100+clip within 5% of dpmpp50+clip and no worse than clipped
    PLMS100."""
    with open(path) as f:
        s = json.load(f)["samplers"]
    assert s["dpmpp50"]["solver_err_l1"] <= s["plms50"]["solver_err_l1"]
    assert (s["dpmpp50_clip"]["gt_err_l1"]
            <= 1.15 * s["plms20_clip"]["gt_err_l1"])
    for name, r in s.items():
        if name.endswith("_clip") and name.startswith("dpmpp"):
            lo, hi = r["mel_range"]
            assert -8.0 <= lo <= hi <= 3.0, (name, r["mel_range"])
    assert (s["dpmpp100_clip"]["gt_err_l1"]
            <= 1.05 * s["dpmpp50_clip"]["gt_err_l1"])
    assert s["dpmpp100_clip"]["gt_err_l1"] <= s["plms100_clip"]["gt_err_l1"]


def test_artifact_set_present():
    """The CPU anchor (``--tiny --device cpu --steps 600``) and one
    production checkpoint of 5,000 steps on 64 clips sampled at f32 and at
    bf16 on the card, each with the card's name and power limit."""
    rels = [os.path.relpath(p, REPO) for p in ARTIFACTS]
    assert "runs/torch_sampler_quality_tiny/summary.json" in rels, rels
    with open(os.path.join(REPO, rels[rels.index(
            "runs/torch_sampler_quality_tiny/summary.json")])) as f:
        tiny = json.load(f)
    assert tiny["dims"] == "tiny" and tiny["backend"] == "cpu"
    assert tiny["train_steps"] == 600
    prod = {}
    for dt in ("f32", "bf16"):
        rel = f"runs/torch_sampler_quality/summary_5000steps_64clips_{dt}.json"
        assert rel in rels, rels
        with open(os.path.join(REPO, rel)) as f:
            prod[dt] = json.load(f)
        s = prod[dt]
        assert s["dims"] == "production 44.1k" and s["backend"] == "cuda"
        assert s["compute_dtype"] == dt and s["train_steps"] == 5000
        assert s["data"] == "synthetic" and s["k2_launches"] == 14
        assert "H100" in s["card"] and " W" in s["card"], s["card"]
    assert prod["f32"]["train_steps"] == prod["bf16"]["train_steps"]


def test_train_demo_artifact():
    """``runs/torch_train_demo``: 300 steps and a resume to 400 on the
    card, K4's batched route (one backward a step), the validation loss
    falling, a finite validation wav."""
    with open(os.path.join(REPO, "runs", "torch_train_demo",
                           "summary.json")) as f:
        s = json.load(f)
    assert "H100" in s["card"] and " W" in s["card"], s["card"]
    assert s["phase1"]["steps"] == 300 and s["resume"]["to_step"] == 400
    assert s["train_route"] == "batched"
    assert s["phase1"]["launches"]["K4"] == 300
    assert s["resume"]["launches"]["K4"] == 100
    assert s["phase1"]["launches"]["K5"] == 0
    assert s["val_loss_curve"][-1][1] < s["val_loss_curve"][0][1]
    assert s["validation_wav"]["finite"] and s["validation_wav"]["rms"] > 0
    assert os.path.exists(os.path.join(REPO, "runs", "torch_train_demo",
                                       "config.yaml"))
