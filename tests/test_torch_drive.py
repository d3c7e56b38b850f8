"""The port's one-command drive and its mel-MCD metric
(``diffsvc_tpu_torch/tools/verify_drive.py``, ``tools/compare_mel.py``)
against the JAX package's tools (``tools/verify_drive.py``,
``tools/compare_mel.py``) on the CPU.

The drive runs once, as a subprocess with ``--device cpu`` at the JAX
drive's widths; its project, trained checkpoint and song then convert
through the port's ``infer_cli`` and the JAX package's ``infer.py`` (run by
``runpy``, as the JAX drive runs it) with one start noise shared between
the two samplers.
"""

import importlib.util
import json
import os
import runpy
import subprocess
import sys

import jax  # noqa: F401  (tests/conftest.py keeps it on the CPU)
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from diffsvc_tpu.infer import hubert_encoder as jhubert
from diffsvc_tpu.models import diffusion as jdiffusion
from diffsvc_tpu_torch.models import diffusion as tdiffusion
from diffsvc_tpu_torch.tools import compare_mel, verify_drive
from diffsvc_tpu_torch.utils import synth
from diffsvc_tpu_torch.utils.audio_io import save_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = ("binarize", "run", "infer_cli", "warm_start")
KERNELS = ("K1", "K2", "K3", "K4", "K5", "K6")


def jax_tool(name: str):
    """``tools/<name>.py`` of the JAX package, loaded under a private name
    (the directory also holds the JAX drive, which runs when imported)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for this module, as
    ``tests/test_torch_voc_learn.py`` runs: under xdist a pool of threads
    per worker oversubscribes the cores (a tiny step_repeat child took 216 s
    on six workers, ~6 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def drive_run(tmp_path_factory):
    """``python -m diffsvc_tpu_torch.tools.verify_drive --device cpu`` in a
    subprocess whose temporary directory is this test's, on one thread (the
    module's reason)."""
    tmp = tmp_path_factory.mktemp("drive")
    env = dict(os.environ, PYTHONPATH=REPO, TMPDIR=str(tmp),
               OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "diffsvc_tpu_torch.tools.verify_drive",
         "--device", "cpu"], cwd=tmp, env=env, capture_output=True,
        text=True, timeout=600)


def summary_of(proc) -> dict:
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.strip().splitlines()
    assert lines[-1] == "ALL VERIFY STEPS PASSED"
    return json.loads(lines[-2])


def test_drive_on_the_cpu_passes(drive_run):
    """Exit 0, the JAX drive's last line, a summary line before it with
    each step's seconds and kernel launches (none on the CPU), the
    trained checkpoint, and an output exactly as long as the input."""
    s = summary_of(drive_run)
    assert s["device"] == "cpu" and s["full"] is False
    assert set(s["steps"]) == set(STEPS)
    for name in STEPS:
        rec = s["steps"][name]
        assert rec["seconds"] >= 0
        assert rec["launches"] == dict.fromkeys(KERNELS, 0), name
    assert s["steps"]["warm_start"]["skipped"] == "cpu"
    assert "asked for the CPU" in drive_run.stdout
    conv = s["steps"]["infer_cli"]
    assert conv["sr"] == verify_drive.SR
    assert conv["samples"] == conv["input_samples"] > 0
    sr, wav = wavfile.read(conv["output"])
    _, src = wavfile.read(s["song"])
    assert sr == verify_drive.SR and len(wav) == len(src)
    assert np.isfinite(wav).all() and np.abs(wav).max() > 0
    assert s["trained_ckpt"].endswith("model_ckpt_steps_4.ckpt")
    assert os.path.exists(os.path.join(s["scratch"], "binary", "train.data"))


def pcm(data: np.ndarray) -> np.ndarray:
    """A wav's int16 samples (both ``save_wav`` copies write int16) in
    [-1, 1)."""
    assert data.dtype == np.int16
    return data.astype(np.float64) / 32768.0


def shared_noise(shape) -> np.ndarray:
    return np.random.RandomState(int(shape[1])).randn(*shape).astype(
        np.float32)


def test_drive_conversion_matches_jax_infer(drive_run, tmp_path,
                                            monkeypatch):
    """The drive's step 3 (``infer_cli`` with the trained checkpoint, the
    unit stand-in) against the JAX package's ``infer.py`` with the same
    flags, project, checkpoint and song: both samplers start from one
    shared noise; the waveform within
    ``test_torch_slice.py::test_svc_infer_matches_jax_chain``'s f32 2e-3."""
    s = summary_of(drive_run)
    paths, ckpt = {"config": s["config"], "song": s["song"]}, s["trained_ckpt"]

    t_infer = tdiffusion.GaussianDiffusion.infer

    def port_infer(self, batch, **kw):
        mels = batch["mels"]
        kw["init_noise"] = torch.from_numpy(shared_noise(tuple(mels.shape)))
        return t_infer(self, batch, **kw)

    j_infer = jdiffusion.GaussianDiffusion.infer

    def jax_infer(self, params, batch, rng, **kw):
        kw["init_noise"] = shared_noise(tuple(batch["mels"].shape))
        return j_infer(self, params, batch, rng, **kw)

    monkeypatch.setattr(tdiffusion.GaussianDiffusion, "infer", port_infer)
    monkeypatch.setattr(jdiffusion.GaussianDiffusion, "infer", jax_infer)
    monkeypatch.setattr(jhubert.Hubertencoder, "encode",
                        verify_drive.stand_in_units)

    (tmp_path / "port").mkdir()
    monkeypatch.chdir(tmp_path / "port")
    out = os.path.abspath(verify_drive.convert(paths, ckpt, False, "cpu"))
    (tmp_path / "jax").mkdir()
    monkeypatch.chdir(tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", [
        "infer.py", "--project", verify_drive.PROJECT, "--model", ckpt,
        "--config", paths["config"], "--files", paths["song"], "--key", "2",
        "--acc", "10", "--no_pe", "--no_crepe"])
    runpy.run_path(os.path.join(REPO, "infer.py"), run_name="__main__")
    ref_fn = [f for f in os.listdir("results") if f.endswith(".wav")]
    assert len(ref_fn) == 1, ref_fn
    ref = pcm(wavfile.read(os.path.join("results", ref_fn[0]))[1])
    got = pcm(wavfile.read(out)[1])
    assert got.shape == ref.shape and np.abs(ref).max() > 1e-2
    np.testing.assert_allclose(got, ref, atol=2e-3)


@pytest.mark.parametrize("case", ["same", "offset", "other", "shorter"])
def test_mcd_matches_the_jax_tool(case):
    """``mel_mcd`` and ``compare_mels`` against the JAX tool's on seeded
    mels (1e-12), with ``tests/test_tools.py::test_compare_mel_mcd``'s
    cases: equal mels read 0, a 0.01 offset reads under 0.5 dB, another
    draw above 1 dB, and the shorter length is compared."""
    jtool = jax_tool("compare_mel")
    rng = np.random.RandomState(0)
    a = rng.randn(100, 80).astype(np.float32)
    b = {"same": a, "offset": a + 0.01, "other": rng.randn(100, 80),
         "shorter": a[:50] + 0.1 * rng.randn(50, 80)}[case]
    got, want = compare_mel.compare_mels(a, b), jtool.compare_mels(a, b)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-12, atol=1e-12)
    assert compare_mel.mel_mcd(a, b) == pytest.approx(jtool.mel_mcd(a, b),
                                                      rel=1e-12, abs=1e-12)
    assert compare_mel.align_lengths(a, b)[1].shape == \
        jtool.align_lengths(a, b)[1].shape
    mcd = got["mcd_db"]
    assert {"same": mcd == 0.0, "offset": 0 < mcd < 0.5, "other": mcd > 1.0,
            "shorter": got["frames"] == 50}[case]


def run_main(main, argv, monkeypatch, capsys):
    """A tool's ``main`` on ``argv``: (exit code, {key: value} printed)."""
    monkeypatch.setattr(sys, "argv", ["compare_mel.py", *argv])
    with pytest.raises(SystemExit) as ex:
        main(argv) if main is compare_mel.main else main()
    out = capsys.readouterr().out
    return ex.value.code, {k: float(v) for k, v in
                           (line.split(": ") for line in out.splitlines())}


@pytest.mark.parametrize("pair", ["near", "far"])
def test_wav_path_matches_the_jax_tool(pair, tmp_path, monkeypatch, capsys):
    """The wav path at config_44k on two synthetic 44.1 kHz wavs: the
    port's MCD within 1e-3 dB of the JAX tool's, the other readings close,
    and both exit codes (0: the same voice 1 dB quieter, which moves only the
    cepstrum's c0, left out of the MCD; 1: another voice a fifth up)."""
    jtool = jax_tool("compare_mel")
    sr = 44100
    ref = synth.voiced_wav(1.0, sr, 220.0, seed=0)
    ours = 0.9 * ref if pair == "near" else synth.voiced_wav(1.0, sr, 330.0,
                                                             seed=1)
    save_wav(ref, str(tmp_path / "ref.wav"), sr)
    save_wav(ours, str(tmp_path / "ours.wav"), sr)
    monkeypatch.chdir(tmp_path)
    argv = ["ref.wav", "ours.wav", "--config",
            os.path.join(REPO, "configs", "config_44k.yaml")]
    code, got = run_main(compare_mel.main, [*argv, "--device", "cpu"],
                         monkeypatch, capsys)
    jcode, want = run_main(jtool.main, argv, monkeypatch, capsys)
    assert code == jcode == (0 if pair == "near" else 1)
    assert set(got) == set(want) == {"mcd_db", "l1", "rmse", "frames"}
    assert got["frames"] == want["frames"] > 0
    assert abs(got["mcd_db"] - want["mcd_db"]) <= 1e-3
    for k in ("l1", "rmse"):
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-5)


def test_step_repeat_child_on_the_cpu(tmp_path):
    """``tools/step_repeat``'s child at the A/B's tiny widths on the CPU:
    after the warm-up steps, each leg's step taken twice gives the same
    record, which holds the loss, every parameter's gradient (the
    embeddings' among them, nonzero), the stack boundary's gradients and
    the updated parameters, each fingerprinted."""
    from diffsvc_tpu_torch.tools import step_repeat

    fn = str(tmp_path / "prints.json")
    res = step_repeat.child("default", fn, True, "cpu", warm=2, repeats=2)
    with open(fn) as f:
        prints = json.load(f)
    assert set(res) == set(prints) == {"batched_bf16", "kernel_f32", "scan"}
    for leg, r in res.items():
        assert r["in_process"] == [[]], leg
        keys = set(prints[leg])
        assert {"loss", "grad:cond", "k:dskip", "k:dcond_proj",
                "grad:fs2.pitch_embed.weight",
                "param:fs2.pitch_embed.weight"} <= keys, leg
        assert any(k.startswith("snap:") for k in keys)
        assert prints[leg]["grad:fs2.pitch_embed.weight"] != [0, 0], leg


def test_step_repeat_records():
    """``runs/torch_step_repeat``, on the card at B=24 x T=1024: before the
    repair, in the default mode and with ``CUBLAS_WORKSPACE_CONFIG`` alone,
    every repeated step differed in the pitch embedding's gradient and in
    nothing upstream of it (the loss, the stack's boundary, the
    conditioner's gradient equal), and
    ``use_deterministic_algorithms`` mended it; after the repair the
    default mode repeats, inside a process and across two."""
    before, after = (json.load(open(os.path.join(
        REPO, "runs", "torch_step_repeat", n))) for n in (
        "step_repeat_before_repair.json", "step_repeat.json"))
    for r in (before, after):
        assert r["device"].startswith("NVIDIA") and r["warm"] == 3
    for mode, legs in before["modes"].items():
        for leg, rec in legs.items():
            takes = [t for p in rec["in_process"] for t in p]
            keys = {k for t in takes for k, _ in t}
            if mode in ("flag", "both"):
                assert keys == set() and rec["across_processes"] == []
            else:
                assert all(takes) and keys == {
                    "grad:fs2.pitch_embed.weight",
                    "param:fs2.pitch_embed.weight"}, (mode, leg)
    assert after["repeats_bit_for_bit"] == {"default": True}
