"""The port's compiled-program export (``infer/export.py``,
``run_exported``, ``onnx_export --format pt2``) and the ``simplify`` CLI
against the JAX package's (``diffsvc_tpu/infer/export.py``,
``tools/run_exported.py``, ``simplify.py``) on the CPU, at the tiny widths
of tests/test_export_misc.py.

Each ``.pt2`` stage is held against JAX's ``jax.export`` artifact of the
same checkpoint on the same seeded inputs (encoder and denoiser 1e-5, the
sampler 1e-4: the ladder against JAX's scan), the vocoder program against
the port's in-process route (JAX draws its NSF source from its own key),
the fused bucket against JAX's ``export_fused`` artifact fed JAX's draws
(the tolerances of tests/test_torch_fused.py) and against the in-process
``FusedSvc`` bit for bit.  On CPU inputs the programs' kernel ops run their
plain versions."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from _torch_fixtures import HID, MEL, voiced_wav, write_project
from diffsvc_tpu.infer import export as jexport
from diffsvc_tpu.infer.fused import FusedSvc as JFusedSvc
from diffsvc_tpu.infer.svc import Svc as JSvc
from diffsvc_tpu.models import hubert as jhubert
from diffsvc_tpu_torch import onnx_export, run_exported
from diffsvc_tpu_torch import simplify as tsimplify
from diffsvc_tpu_torch.infer import export as texport
from diffsvc_tpu_torch.infer import hubert_encoder
from diffsvc_tpu_torch.infer.fused import FusedSvc
from diffsvc_tpu_torch.infer.svc import Svc as TSvc
from diffsvc_tpu_torch.models import diffnet
from diffsvc_tpu_torch.models.hubert import HubertConfig
from diffsvc_tpu_torch.ops.hopper import vocoder_tail
from diffsvc_tpu_torch.training import checkpoint as tckpt
from diffsvc_tpu_torch.utils.synth import write_hubert
from diffsvc_tpu_torch.vocoders import generator

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_MEL, T_PH = 32, 16
ACC = 10
HUB = dict(dim=32, num_heads=2, num_layers=2, ffn_dim=64, proj_dim=HID)
STAGES = ("encoder", "denoiser", "sampler", "vocoder")


def _features(seed: int = 0) -> dict:
    """Seeded numpy inputs of the chain (tests/test_export_misc.py's, with
    a moving f0 and a padded tail)."""
    rng = np.random.RandomState(seed)
    mel2ph = np.clip(np.arange(T_MEL) * T_PH // T_MEL + 1, 1, T_PH)
    mel2ph[-3:] = 0
    f0 = np.log2(220.0 * 2 ** (0.3 * np.sin(np.arange(T_MEL) / 5.0)))
    return dict(
        hubert=(rng.randn(1, T_PH, HID) * 0.1).astype(np.float32),
        mel2ph=mel2ph[None].astype(np.int32),
        f0=f0[None].astype(np.float32),
        uv=np.zeros((1, T_MEL), np.float32),
        energy=np.zeros((1, T_MEL), np.float32),
        noise=rng.randn(1, T_MEL, MEL).astype(np.float32))


def _t(a):
    """numpy -> torch, JAX's int32 inputs as the port's int64."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t.long() if a.dtype == np.int32 else t


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """The tiny project, the port's Svc and HuBERT, the JAX Svc and its
    HuBERT params, and both packages' artifacts: the port's through
    ``onnx_export --format pt2 --device cpu --vocoder`` (which runs
    ``SvcExporter``), JAX's through its ``SvcExporter``."""
    root = tmp_path_factory.mktemp("torch_export")
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
    t_dir, j_dir = str(root / "pt2"), str(root / "jax")
    paths = onnx_export.main([
        "--project", "proj", "--model", ckpt, "--config", cfg_fn, "--out",
        t_dir, "--format", "pt2", "--device", "cpu", "--vocoder",
        "--t_mel", str(T_MEL), "--t_ph", str(T_PH), "--acc", str(ACC)])
    j_paths = jexport.SvcExporter(jsvc.hp, jsvc.params).export(
        j_dir, t_mel=T_MEL, t_ph=T_PH, speedup=ACC)
    return dict(root=root, cfg_fn=cfg_fn, ckpt=ckpt, hub_fn=hub_fn,
                tsvc=tsvc, jsvc=jsvc, t_dir=t_dir, t=paths, j=j_paths,
                thub=hubert_encoder.load(hub_fn, cfg=HubertConfig(**HUB)),
                jhub=jhubert.load(hub_fn, jhubert.HubertConfig(**HUB)))


def _randoms(gen, batch=1, t_mel=T_MEL):
    """The vocoder program's NSF draws: the port's draw from seed 0."""
    cfg = gen.cfg
    return generator.draw_randoms(batch, t_mel * int(np.prod(
        cfg.upsample_rates)), cfg.harmonic_num, torch.Generator().manual_seed(0))


def _vocoder_inputs():
    rng = np.random.RandomState(3)
    mel = (rng.rand(1, T_MEL, MEL) * 4.0 - 5.0).astype(np.float32)
    f0 = (220.0 * 2 ** (0.2 * np.sin(np.arange(T_MEL) / 4.0)))[None]
    f0[:, 10:14] = 0.0
    return torch.from_numpy(mel), torch.from_numpy(f0.astype(np.float32))


def test_pt2_cli_writes_the_set(sides):
    """The CLI writes the four programs and JAX's meta keys plus the
    device and the compute dtype."""
    assert set(sides["t"]) == set(STAGES)
    assert sorted(os.listdir(sides["t_dir"])) == sorted(
        [f"{s}.pt2" for s in STAGES] + ["export_meta.json"])
    with open(os.path.join(sides["t_dir"], "export_meta.json")) as f:
        meta = json.load(f)
    with open(os.path.join(os.path.dirname(sides["j"]["encoder"]),
                           "export_meta.json")) as f:
        jmeta = json.load(f)
    assert meta == dict(jmeta, device="cpu", dtype="float32")


@pytest.mark.parametrize("stage", ["encoder", "denoiser", "sampler"])
def test_stage_matches_jax_artifact(sides, stage):
    """Each stage's program against JAX's ``jax.export`` artifact on the
    same inputs: the encoder and the denoiser to 1e-5, the sampler (K2's
    ladder against JAX's PLMS scan, 6 evaluations) to 1e-4."""
    feats = _features()
    port = texport.load_exported(sides["t"][stage])
    jx = jexport.load_exported(sides["j"][stage])
    rng = np.random.RandomState(1)
    if stage == "encoder":
        names = ("hubert", "mel2ph", "f0", "uv", "energy")
        got = port(*(_t(feats[k]) for k in names))
        ref = jx(*(feats[k] for k in names))
        tol = 1e-5
    elif stage == "denoiser":
        cond = (rng.randn(1, T_MEL, HID) * 0.5).astype(np.float32)
        t = np.asarray([17], np.int32)
        got = [port(_t(feats["noise"]), _t(t), _t(cond))]
        ref = [jx(feats["noise"], t, cond)]
        tol = 1e-5
    else:
        cond = (rng.randn(1, T_MEL, HID) * 0.5).astype(np.float32)
        got = [port(_t(cond), _t(feats["noise"]))]
        ref = [jx(cond, feats["noise"])]
        tol = 1e-4
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        r = np.asarray(r)
        assert tuple(g.shape) == r.shape
        np.testing.assert_allclose(g.numpy(), r, rtol=tol, atol=tol)


def test_vocoder_program_equals_in_process_route(sides):
    """The vocoder program (its NSF draws fixed inside) equals
    ``generator.apply_serving`` on the same draws bit for bit."""
    gen = sides["tsvc"].vocoder.gen
    mel, f0 = _vocoder_inputs()
    got = texport.load_exported(sides["t"]["vocoder"])(mel, f0)
    with torch.no_grad():
        ref = generator.apply_serving(gen, mel, f0, _randoms(gen))
    assert got.shape == ref.shape == (1, T_MEL * 64)
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _plain_program(sides, stage):
    """The same stage traced on the kernels' plain routes: the denoiser
    through ``diffnet.apply(plain=True)`` (``residual_stack_plain``), the
    vocoder through ``generator.apply`` (the whole generator in torch)."""
    model, gen = sides["tsvc"].model, sides["tsvc"].vocoder.gen
    if stage == "denoiser":
        x = torch.zeros(1, T_MEL, MEL)
        return texport.export_program(
            lambda x, t, c: diffnet.apply(model.denoise_fn, x, t, c,
                                          plain=True),
            (x, torch.zeros(1, dtype=torch.long), torch.zeros(1, T_MEL, HID)))
    randoms = _randoms(gen)
    return texport.export_program(
        lambda mel, f0: generator.apply(gen, mel, f0, randoms),
        _vocoder_inputs())


@pytest.mark.parametrize("stage", ["denoiser", "sampler", "vocoder"])
def test_programs_hold_the_kernel_ops(sides, stage):
    """The saved graph calls the kernel op of its stage, and no plain
    route is baked in: the op's weights are read by nothing else, and the
    plain route's trace holds exactly the stack's 4 L products (three taps
    and the output 1x1 a layer) or the tail's convolutions more.  On CPU
    inputs the op reaches its plain version: the denoiser program equals
    the plain route bit for bit."""
    rep = texport.program_ops(sides["t"][stage])
    want = {"denoiser": {"residual_stack": 1},
            "sampler": {"plms_ladder": 1},
            "vocoder": {"vocoder_tail": 1}}[stage]
    assert rep["ops"] == want and rep["shared"] == []
    net = sides["tsvc"].model.denoise_fn
    if stage == "sampler":
        # one plain evaluation would add 3 + 4 L products
        assert rep["products"] < 3 + 4 * net.n_layers
        return
    plain = texport.program_ops(_plain_program(sides, stage))
    assert plain["ops"] == {}
    gen = sides["tsvc"].vocoder.gen
    extra = 4 * net.n_layers if stage == "denoiser" else len(
        vocoder_tail.flatten_plan(gen.tail_plan(
            generator.tail_start_stage(gen.cfg)))[0])
    assert plain["products"] - rep["products"] == extra
    if stage == "denoiser":
        feats = _features()
        args = (_t(feats["noise"]), torch.tensor([17]),
                torch.from_numpy(np.random.RandomState(1).randn(
                    1, T_MEL, HID).astype(np.float32)))
        got = texport.load_exported(sides["t"][stage])(*args)
        with torch.no_grad():
            ref = diffnet.apply(net, *args, plain=True)
        np.testing.assert_array_equal(got.numpy(), ref.numpy())


def _jax_draws(rng, pad_t, n_voc, harmonics=9):
    """JAX's draws inside its fused program (tests/test_torch_fused.py)."""
    noise = jax.random.normal(jax.random.split(rng)[0], (1, pad_t, MEL))
    k1, k2 = jax.random.split(jax.random.fold_in(rng, 7))
    return (np.asarray(noise),
            np.asarray(jax.random.uniform(k1, (1, harmonics))),
            np.asarray(jax.random.normal(k2, (1, harmonics, n_voc))))


@pytest.fixture(scope="module")
def fused(sides):
    """Both packages' fused programs of one bucket (the 0.9 s clip's
    length, unbucketed), the port's FusedSvc and the clip."""
    tsvc, jsvc = sides["tsvc"], sides["jsvc"]
    jf = JFusedSvc(jsvc.hp, jsvc.params, jsvc.vocoder,
                   hubert_params=sides["jhub"],
                   hubert_cfg=jhubert.HubertConfig(**HUB), speedup=ACC)
    tf = FusedSvc(tsvc.hp, tsvc.model, tsvc.vocoder, sides["thub"],
                  speedup=ACC)
    wav = voiced_wav(secs=0.9, f0=220.0, gaps=[(0.5, 0.6)])
    out = str(sides["root"] / "fused")
    return dict(jf=jf, tf=tf, wav=wav, dir=out,
                t=texport.export_fused(tf, out, len(wav)),
                j=jexport.export_fused(jf, str(sides["root"] / "jfused"),
                                       len(wav)))


def test_fused_program_matches_jax_and_in_process(fused):
    """The fused program fed JAX's draws against JAX's ``export_fused``
    artifact at f32 (wav and mel 2e-3, f0 rtol 1e-4, as
    ``test_fused_matches_jax``), and equal to the in-process FusedSvc on
    the same draws bit for bit; the meta records the draws' shapes."""
    tf, wav = fused["tf"], fused["wav"]
    n44 = len(wav)
    g = tf.geometry(n44)
    key = jax.random.PRNGKey(9)
    noise, rand_ini, unit_noise = _jax_draws(key, g["pad_t"], g["n_voc"])
    with open(os.path.join(fused["dir"], "fused_meta.json")) as f:
        meta = json.load(f)[str(n44)]
    assert [(d["name"], tuple(d["shape"])) for d in meta["draws"]] == [
        ("noise", noise.shape), ("rand_ini", rand_ini.shape),
        ("unit_noise", unit_noise.shape)]
    assert meta["device"] == "cpu" and meta["speedup"] == ACC
    got = texport.load_exported(fused["t"])(
        torch.from_numpy(wav), torch.tensor(2.0), torch.tensor(0),
        *(torch.from_numpy(np.array(a)) for a in (noise, rand_ini, unit_noise)))
    got = [a.numpy() for a in got]
    ref = [np.asarray(a) for a in jexport.load_exported(fused["j"])(
        wav, np.asarray(key, np.uint32), np.float32(2.0), np.int32(0))]
    for a, r in zip(got, ref):
        assert a.shape == r.shape
    np.testing.assert_array_equal(got[1] > 0, ref[1] > 0)
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-4)
    np.testing.assert_allclose(got[2], ref[2], atol=2e-3)
    np.testing.assert_allclose(got[0], ref[0], atol=2e-3)
    assert np.abs(ref[0]).max() > 1e-2
    inproc = tf(wav, init_noise=noise, voc_randoms=(rand_ini, unit_noise),
                key_shift=2)
    for a, r in zip(got, inproc):
        np.testing.assert_array_equal(a, r)
    rep = texport.program_ops(fused["t"])
    assert rep["ops"] == {"plms_ladder": 1, "vocoder_tail": 1}
    assert rep["shared"] == []


FRESH = r"""
import json, os, sys
import numpy as np
import torch
import diffsvc_tpu_torch.ops.hopper as hopper
from diffsvc_tpu_torch import run_exported
d = sys.argv[1]
ins = np.load(os.path.join(d, "inputs.npz"))
outs = {}
with torch.no_grad():
    for stage, names in (("encoder", ("hubert", "mel2ph", "f0", "uv",
                                      "energy")),
                         ("denoiser", ("noise", "t", "cond")),
                         ("sampler", ("cond", "noise")),
                         ("vocoder", ("mel", "f0_hz"))):
        prog = hopper.load_program(os.path.join(d, "pt2", stage + ".pt2"))
        res = prog(*(torch.from_numpy(ins[k]) for k in names))
        res = res if isinstance(res, (tuple, list)) else [res]
        for i, r in enumerate(res):
            outs[f"{stage}{i}"] = r.numpy()
    fused = hopper.load_program(ins["fused"].item())
    for i, r in enumerate(fused(torch.from_numpy(ins["wav"]),
                                torch.tensor(2.0), torch.tensor(0),
                                *(torch.from_numpy(ins[k]) for k in
                                  ("fnoise", "rand_ini", "unit_noise")))):
        outs[f"fused{i}"] = r.numpy()
run_exported.main(["--export_dir", os.path.join(d, "pt2"), "--features",
                   os.path.join(d, "feats.npz"), "--out",
                   os.path.join(d, "fresh_out")])
np.savez(os.path.join(d, "outs.npz"), **outs)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "diffsvc_tpu")
             or m.startswith(("diffsvc_tpu_torch.models",
                              "diffsvc_tpu_torch.infer",
                              "diffsvc_tpu_torch.vocoders")))
print(json.dumps({"bad": bad}))
"""


def test_programs_run_in_a_fresh_process(sides, fused, tmp_path):
    """The stages, the fused bucket and ``run_exported`` run in a new
    process that imports the op library only: no ``jax``, no module of
    ``diffsvc_tpu`` and none of the port's models, infer or vocoders in
    ``sys.modules``; each result equals this process's run of the same
    program."""
    feats = _features()
    rng = np.random.RandomState(5)
    g = fused["tf"].geometry(len(fused["wav"]))
    mel, f0_hz = _vocoder_inputs()
    ins = dict({k: v.astype(np.int64) if k == "mel2ph" else v
                for k, v in feats.items()},
               t=np.asarray([17]), cond=rng.randn(1, T_MEL, HID).astype(
                   np.float32),
               mel=mel.numpy(), f0_hz=f0_hz.numpy(), wav=fused["wav"],
               fused=np.asarray(fused["t"]),
               fnoise=rng.randn(1, g["pad_t"], MEL).astype(np.float32),
               rand_ini=rng.rand(1, 9).astype(np.float32),
               unit_noise=rng.randn(1, 9, g["n_voc"]).astype(np.float32))
    np.savez(tmp_path / "inputs.npz", **ins)
    np.savez(tmp_path / "feats.npz", **feats)
    os.symlink(sides["t_dir"], tmp_path / "pt2")
    proc = subprocess.run(
        [sys.executable, "-c", FRESH, str(tmp_path)], cwd=tmp_path,
        env=dict(os.environ, PYTHONPATH=REPO), capture_output=True,
        text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"bad": []}
    outs = np.load(tmp_path / "outs.npz")
    with torch.no_grad():
        for stage, names in (("encoder", ("hubert", "mel2ph", "f0", "uv",
                                          "energy")),
                             ("denoiser", ("noise", "t", "cond")),
                             ("sampler", ("cond", "noise")),
                             ("vocoder", ("mel", "f0_hz"))):
            res = texport.load_exported(sides["t"][stage])(
                *(torch.from_numpy(ins[k]) for k in names))
            res = res if isinstance(res, (tuple, list)) else [res]
            for i, r in enumerate(res):
                np.testing.assert_array_equal(outs[f"{stage}{i}"], r.numpy())
        res = texport.load_exported(fused["t"])(
            torch.from_numpy(fused["wav"]), torch.tensor(2.0),
            torch.tensor(0), *(torch.from_numpy(ins[k]) for k in
                               ("fnoise", "rand_ini", "unit_noise")))
    for i, r in enumerate(res):
        np.testing.assert_array_equal(outs[f"fused{i}"], r.numpy())
    assert (tmp_path / "fresh_out" / "wav.npy").exists()


def test_run_exported_chain_matches_in_process(sides, tmp_path):
    """``run_exported`` (encoder -> sampler -> mask -> vocoder) equals the
    in-process ``GaussianDiffusion.infer`` on the same noise and the
    vocoder's route on its mel and f0, as tests/test_export_misc.py:132
    holds JAX's consumer."""
    feats = _features()
    np.savez(tmp_path / "feats.npz", **feats)
    run_exported.main(["--export_dir", sides["t_dir"], "--features",
                       str(tmp_path / "feats.npz"), "--out",
                       str(tmp_path / "out")])
    model = sides["tsvc"].model
    batch = {k: _t(v) for k, v in feats.items() if k != "noise"}
    out = model.infer(batch, speedup=ACC, init_noise=_t(feats["noise"]))
    mel = np.load(tmp_path / "out" / "mel.npy")
    np.testing.assert_array_equal(mel, out["mel_out"].numpy())
    gen = sides["tsvc"].vocoder.gen
    with torch.no_grad():
        wav = generator.apply_serving(gen, torch.from_numpy(mel),
                                      out["f0_denorm"], _randoms(gen))
    np.testing.assert_array_equal(np.load(tmp_path / "out" / "wav.npy"),
                                  wav.numpy())


def test_run_exported_fused_matches_in_process(fused, tmp_path):
    """``run_exported --fused --seed 4 --key 2`` equals the in-process
    FusedSvc with ``torch.Generator().manual_seed(4)`` (the draws in the
    same order) bit for bit, as tests/test_export_misc.py:243-254 holds
    JAX's consumer."""
    np.save(tmp_path / "in.npy", fused["wav"])
    run_exported.main(["--export_dir", fused["dir"], "--features",
                       str(tmp_path / "in.npy"), "--out",
                       str(tmp_path / "out"), "--fused", "--key", "2",
                       "--seed", "4"])
    ref = fused["tf"](fused["wav"], torch.Generator().manual_seed(4),
                      key_shift=2)
    for name, r in zip(("wav", "f0", "mel"), ref):
        np.testing.assert_array_equal(np.load(tmp_path / "out" /
                                              f"{name}.npy"), r)


@pytest.mark.parametrize("mode", ["chain", "fused"])
def test_run_exported_refuses_a_missing_card(sides, fused, tmp_path, mode,
                                             monkeypatch):
    """A program exported on the card raises where there is none: no
    fallback to the CPU."""
    src = fused["dir"] if mode == "fused" else sides["t_dir"]
    name = "fused_meta.json" if mode == "fused" else "export_meta.json"
    d = tmp_path / "exp"
    d.mkdir()
    with open(os.path.join(src, name)) as f:
        meta = json.load(f)
    for v in (meta.values() if mode == "fused" else [meta]):
        v["device"] = "cuda"
    with open(d / name, "w") as f:
        json.dump(meta, f)
    np.savez(tmp_path / "f.npz", wav=fused["wav"], **_features())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_exported.main(["--export_dir", str(d), "--features",
                           str(tmp_path / "f.npz"), "--out",
                           str(tmp_path / "o")]
                          + (["--fused"] if mode == "fused" else []))


def test_pt2_cli_exports_on_the_card_by_default(sides, tmp_path,
                                                 monkeypatch):
    """``--format pt2`` without ``--device`` asks for the card and raises
    without one; ``SvcExporter`` likewise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        onnx_export.main(["--project", "proj", "--model", sides["ckpt"],
                          "--config", sides["cfg_fn"], "--out",
                          str(tmp_path), "--format", "pt2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        texport.SvcExporter(sides["tsvc"].hp, sides["tsvc"].model)
    assert not os.listdir(tmp_path)


def test_cli_refuses_stablehlo_naming_pt2(capsys):
    with pytest.raises(SystemExit) as e:
        onnx_export.main(["--project", "p", "--format", "stablehlo"])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "XLA" in err and "--format pt2" in err


def test_simplify_cli_matches_jax_keys(sides, tmp_path, monkeypatch):
    """``python -m diffsvc_tpu_torch.simplify --proj p --steps N`` writes
    ``./clean_model_ckpt_steps_N.ckpt`` as ``simplify.py`` does: the
    optimizer state dropped, the step and epoch kept, the model's weights
    (JAX: ``state.params``; the port: the reference ``state_dict``) as
    they were."""
    import runpy

    from diffsvc_tpu.training import checkpoint as jckpt

    jsvc = sides["jsvc"]
    sd = tckpt.torch_load(sides["ckpt"])["state_dict"]
    for name, save, state in (
            ("port", tckpt.save_checkpoint,
             {"state_dict": sd, "optimizer_states": [{"state": {0: 1}}]}),
            ("jax", jckpt.save_checkpoint,
             {"params": jsvc.params, "opt_state": {"mu": np.ones(3)}})):
        d = tmp_path / name
        save(str(d / "checkpoints" / "p"), state, 2, 40)
        monkeypatch.chdir(d)
        if name == "port":
            out = tsimplify.main(["--proj", "p", "--steps", "40"])
        else:
            monkeypatch.setattr(sys, "argv", ["simplify.py", "--proj", "p",
                                              "--steps", "40"])
            runpy.run_path(os.path.join(REPO, "simplify.py"),
                           run_name="__main__")
            out = "./clean_model_ckpt_steps_40.ckpt"
        assert os.path.exists(d / "clean_model_ckpt_steps_40.ckpt")
        if name == "port":
            slim = torch.load(out, weights_only=False)
        else:
            import pickle

            with open(out, "rb") as f:
                jslim = pickle.load(f)
    assert set(slim) == {"state_dict", "epoch", "global_step"}
    assert set(jslim) == {"state", "epoch", "global_step"}
    assert set(jslim["state"]) == {"params"}
    assert (slim["epoch"], slim["global_step"]) == (
        jslim["epoch"], jslim["global_step"]) == (2, 40)
    assert set(slim["state_dict"]) == set(sd)
    for k, v in sd.items():
        assert torch.equal(slim["state_dict"][k], v)
