"""The port stands alone: ``chip_smoke.py`` imports nothing of JAX or of the
JAX package and refuses to run without a card or outside a checkout; the
port's copies of the JAX package's config loader and audio I/O give the same
results as the originals."""

import ast
import importlib
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml
from scipy.io import wavfile

from diffsvc_tpu.utils import audio_io as jaio
from diffsvc_tpu_torch.utils import audio_io as taio

# the modules (each package's ``config.hparams`` attribute is the singleton)
jhp = importlib.import_module("diffsvc_tpu.config.hparams")
thp = importlib.import_module("diffsvc_tpu_torch.config.hparams")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMOKE = os.path.join(REPO, "chip_smoke.py")


def test_chip_smoke_imports_nothing_of_jax():
    """Every import statement of chip_smoke.py, at any depth: no jax, no
    module of ``diffsvc_tpu``."""
    with open(SMOKE) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert "diffsvc_tpu_torch" in {m.split(".")[0] for m in mods}
    bad = sorted(m for m in mods if m.split(".")[0] in
                 ("jax", "jaxlib", "flax", "optax", "diffsvc_tpu"))
    assert bad == []


@pytest.mark.parametrize("where,rc", [("checkout", 3), ("alone", 2)])
def test_chip_smoke_refuses_without_card_or_checkout(tmp_path, where, rc):
    """No CUDA device: exit 3.  A directory holding chip_smoke.py and
    nothing else of the repo: exit 2.  Neither prints a result line."""
    script = SMOKE
    if where == "alone":
        script = str(tmp_path / "chip_smoke.py")
        shutil.copy(SMOKE, script)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, script], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == rc, proc.stderr[-2000:]
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout


def _write(fn, cfg):
    with open(fn, "w") as f:
        yaml.safe_dump(cfg, f)
    return str(fn)


def test_config_copy_matches_reference(tmp_path, monkeypatch):
    """set_hparams over a base_config chain, a saved work-dir config and
    string overrides; save_hparams; the spec-stats write-back."""
    monkeypatch.chdir(tmp_path)
    _write(tmp_path / "base.yaml", {"a": 1, "nested": {"x": 1, "y": 2},
                                    "lr": 0.1, "flag": False})
    cfg = _write(tmp_path / "child.yaml", {"base_config": "base.yaml",
                                          "nested": {"y": 3}, "b": "s"})
    os.makedirs("checkpoints/exp")
    _write(tmp_path / "checkpoints" / "exp" / "config.yaml", {"a": 7})
    got = {}
    for name, mod in (("jax", jhp), ("torch", thp)):
        for reset in (False, True):
            got[name, reset] = mod.set_hparams(
                config=cfg, exp_name="exp", hparams_str="lr=0.5,flag=true",
                print_hparams=False, global_hparams=False, reset=reset)
    for reset in (False, True):
        assert dict(got["torch", reset]) == dict(got["jax", reset])
    assert got["torch", False]["a"] == 7 and got["torch", True]["a"] == 1
    texts = []
    for mod in (jhp, thp):
        hp = dict(got["jax", True], config_path=_write(tmp_path / "c.yaml",
                                                       {"k": 1}))
        mod.write_back_spec_stats(hp, [-1.0, -2.0], [1.0, 2.0])
        mod.save_hparams(hp, str(tmp_path / "work"))
        texts.append((open(tmp_path / "c.yaml").read(),
                      open(tmp_path / "work" / "config.yaml").read()))
    assert texts[0] == texts[1]


@pytest.mark.parametrize("kind", ["int16_stereo", "float32_mono"])
def test_audio_io_copy_matches_reference(tmp_path, kind):
    """load_wav (resampled, mixed down), load_wav_nsf and save_wav give the
    same samples and bytes as the JAX package's audio I/O."""
    rng = np.random.RandomState(0)
    fn = str(tmp_path / "in.wav")
    if kind == "int16_stereo":
        wavfile.write(fn, 22050, (rng.randn(4410, 2) * 3000).astype(np.int16))
    else:
        wavfile.write(fn, 22050, (rng.randn(4410) * 0.3).astype(np.float32))
    for sr in (None, 16000):
        (a, sa), (b, sb) = taio.load_wav(fn, sr=sr), jaio.load_wav(fn, sr=sr)
        assert sa == sb and a.dtype == b.dtype and np.array_equal(a, b)
    (a, sa), (b, sb) = (taio.load_wav_nsf(fn, target_sr=44100),
                        jaio.load_wav_nsf(fn, target_sr=44100))
    assert sa == sb and np.array_equal(a, b)
    wav = rng.randn(1000).astype(np.float32)
    taio.save_wav(wav, str(tmp_path / "t.wav"), 8000, norm=True)
    jaio.save_wav(wav, str(tmp_path / "j.wav"), 8000, norm=True)
    assert open(tmp_path / "t.wav", "rb").read() == \
        open(tmp_path / "j.wav", "rb").read()
    assert taio.format_wav(fn) == jaio.format_wav(fn) == fn


@pytest.mark.parametrize("block", [1600, 100, 257], ids=["large", "sub",
                                                          "odd"])
def test_streaming_copy_matches_reference(block):
    """``diffsvc_tpu_torch/infer/streaming.py`` against the original: the
    same stateful converter (left context, held-tail crossfade, sub-
    crossfade accumulation, flush) gives the same samples, bit for bit."""
    from diffsvc_tpu.infer import streaming as jst
    from diffsvc_tpu_torch.infer import streaming as tst

    rs = np.random.RandomState(block)
    x = rs.randn(8 * block + 37).astype(np.float32)

    def convert(w):          # not stateless: the seams must be blended
        return np.tanh(1.5 * w) + 0.01 * len(w)

    outs = []
    for mod in (jst, tst):
        s = mod.StreamingConverter(convert, 8000, context_ms=100.0,
                                   crossfade_ms=40.0)
        got = [s(x[i: i + block]) for i in range(0, len(x), block)]
        got.append(s.flush())
        outs.append((got, mod.boundary_jump(got)))
    (a, ja), (b, jb) = outs
    assert ja == jb and len(a) == len(b)
    for u, v in zip(a, b):
        np.testing.assert_array_equal(u, v)
