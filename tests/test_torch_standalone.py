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


FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "diffsvc_tpu", "onnx",
             "onnxscript")


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in FORBIDDEN or mod.startswith("google.protobuf")


def test_chip_smoke_imports_nothing_of_jax():
    """Every import statement of chip_smoke.py, at any depth: no jax, no
    module of ``diffsvc_tpu``, no ``onnx``, ``onnxscript`` or
    ``google.protobuf``."""
    with open(SMOKE) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            mods.add(node.module)
    assert "diffsvc_tpu_torch" in {m.split(".")[0] for m in mods}
    assert sorted(m for m in mods if _forbidden(m)) == []


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and not node.level:
            mods.add(node.module)
    return mods


PORT_SOURCES = sorted(
    os.path.relpath(os.path.join(d, f), REPO)
    for d, _, files in os.walk(os.path.join(REPO, "diffsvc_tpu_torch"))
    for f in files if f.endswith(".py"))


@pytest.mark.parametrize("source", PORT_SOURCES)
def test_port_source_imports_nothing_of_jax(source):
    """Every module of the port, the conversion modules of this slice
    (``ops/crepe.py``, ``models/pe.py``, ``models/contentvec.py``,
    ``vocoders/hifigan.py``, ``vocoders/vocoder_utils.py``) and the ONNX
    export among them, at any depth of its import statements: no jax, no
    module of ``diffsvc_tpu``, no ``onnx``, ``onnxscript`` or
    ``google.protobuf`` (relative imports stay inside the port)."""
    bad = sorted(m for m in _imports(os.path.join(REPO, source))
                 if _forbidden(m))
    assert bad == []


def test_port_sources_cover_this_slice():
    for mod in ("ops/crepe.py", "models/pe.py", "models/contentvec.py",
                "vocoders/hifigan.py", "vocoders/vocoder_utils.py",
                "training/pe_task.py", "training/losses.py",
                "training/test_runner.py", "ops/ssim.py", "ops/cwt.py",
                "data/textgrid.py", "utils/misc.py", "utils/multiprocess.py",
                "utils/text_encoder.py", "utils/text_norm.py",
                "ops/loudness.py", "ops/istft.py", "ops/stft_loss.py",
                "vocoders/pwg.py", "vocoders/melgan.py",
                "vocoders/istft_head.py", "vocoders/source.py",
                "vocoders/pqmf.py", "vocoders/discriminators.py",
                "training/vocoder_task.py", "onnx/wire.py",
                "onnx/builder.py", "onnx/convert.py", "onnx/runtime.py",
                "onnx/svc_export.py", "onnx/chain.py", "onnx_export.py",
                "tools/train_demo.py", "tools/sampler_quality.py",
                "tools/train_istft.py", "tools/ab_vocoder.py",
                "tools/ab_train_stream.py", "tools/verify_drive.py",
                "tools/compare_mel.py", "tools/step_repeat.py"):
        assert os.path.join("diffsvc_tpu_torch", mod) in PORT_SOURCES


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


def _textgrid_text(intervals):
    xmax = intervals[-1][1]
    lines = ['File type = "ooTextFile"', 'Object class = "TextGrid"', "",
             "xmin = 0.0", f"xmax = {xmax}", "tiers? <exists>", "size = 1",
             "item []:", "    item [1]:", '        class = "IntervalTier"',
             '        name = "phones"', "        xmin = 0.0",
             f"        xmax = {xmax}",
             f"        intervals: size = {len(intervals)}"]
    for i, (a, b, t) in enumerate(intervals):
        lines += [f"        intervals [{i + 1}]", f"            xmin = {a}",
                  f"            xmax = {b}", f'            text = "{t}"']
    return "\n".join(lines)


def _run_textgrid(mod, tmp):
    """tests/test_textgrid.py's alignments (and its two failures)."""
    hp = {"audio_sample_rate": 1000, "hop_size": 100}
    out = [mod.parse_textgrid(_textgrid_text(
        [(0.0, 0.2, "sil"), (0.2, 0.5, "AA"), (0.5, 0.8, "B"),
         (0.8, 1.0, "")]))[0].intervals,
        mod._merge_silences([mod.Interval(0.0, 0.1, "sp"),
                             mod.Interval(0.1, 0.2, "SIL"),
                             mod.Interval(0.2, 0.5, "AA")])]
    for k, (ivs, ph) in enumerate([
            ([(0.0, 0.2, "sil"), (0.2, 0.5, "AA"), (0.5, 0.8, "B"),
              (0.8, 1.0, "sp")], "<sil> AA B <sil>"),
            ([(0.0, 0.5, "AA"), (0.5, 1.0, "B")], "AA <sp> B"),
            ([(0.0, 0.6, "AA"), (0.6, 1.0, "")], "AA <sil> <sil>"),
            ([(0.0, 0.5, "AA"), (0.5, 1.0, "B")], "AA B C"),
            ([(0.0, 0.5, "AA"), (0.5, 1.0, "B")], "AA C")]):
        fn = tmp / f"{mod.__name__}_{k}.TextGrid"
        fn.write_text(_textgrid_text(ivs))
        try:
            out.append([a.tolist() for a in mod.get_mel2ph(str(fn), ph, 10,
                                                           hp)])
        except ValueError as e:
            out.append(str(e))
    return [[tuple(iv) for iv in x] if isinstance(x, list) and x
            and hasattr(x[0], "text") else x for x in out]


def _run_cwt(mod, tmp):
    """tests/test_tools.py's round trip: decompose and reconstruct."""
    t = np.arange(400) * 0.005
    f0 = 220.0 * 2 ** (0.3 * np.sin(2 * np.pi * 5.0 * t))
    f0[50:60] = 0.0
    uv, lf0 = mod.get_cont_lf0(f0)
    w, scales = mod.get_lf0_cwt((lf0 - lf0.mean()) / lf0.std())
    wn, mean, std = mod.norm_scale(w)
    return [uv, lf0, w, scales, wn, mean, std,
            mod.cwt2f0(wn, lf0.mean(), lf0.std(), scales)]


def _square(x):
    return x * x


def _run_multiprocess(mod, tmp):
    """tests/test_tools.py's ordered map, and the unordered one's set."""
    args = [(i,) for i in range(10)]
    return [list(mod.chunked_multiprocess_run(_square, args, num_workers=3)),
            sorted(mod.chunked_multiprocess_run(_square, args, num_workers=2,
                                                ordered=False))]


def _run_text_encoder(mod, tmp):
    """tests/test_legacy_modules.py's round trips."""
    enc = mod.TokenTextEncoder(["a", "b", "c"], replace_oov="|")
    enc2 = mod.TokenTextEncoder(["a", "|"], replace_oov="|")
    return [enc.vocab_size, enc.encode("a c b"), enc.decode(enc.encode("a c b")),
            enc.pad(), enc.eos(), enc2.decode(enc2.encode("a zz")),
            enc.decode([mod.PAD_ID] + enc.encode("a"), strip_padding=True),
            mod.TextEncoder().encode("1 2 3")]


def _run_text_norm(mod, tmp):
    """tests/test_text_norm.py's readings and round trips."""
    nums = [0, 5, 10, 15, 105, 1234, 10005, 1000500, 100050000, 123456789,
            1_0000_0000_0000, "3.14", -42, "0.50"]
    texts = ["共有1234人，平均3.5分", "涨了95%", "完成了2/3", "百分之15",
             "电话13812345678", "固话0595-23861234", "2019年5月29日发布",
             "30号见", "卖13.5元", "￥200", "编号1000000000000001",
             "编号12345678901234567.5元", "-99999999999999999"]
    return ([mod.num2chn(n) for n in nums]
            + [mod.num2chn(123, big=True), mod.num2chn(200, alt_two=True),
               mod.num2chn(20000, traditional=True)]
            + [mod.chn2num(s) for s in ("十五", "两百", "三万五千", "负四十二",
                                        "壹佰贰拾叁")]
            + [mod.NSWNormalizer(s).normalize() for s in texts])


def _same(a, b):
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name,original,copy,run", [
    ("textgrid", "diffsvc_tpu.data.textgrid",
     "diffsvc_tpu_torch.data.textgrid", _run_textgrid),
    ("cwt", "diffsvc_tpu.ops.cwt", "diffsvc_tpu_torch.ops.cwt", _run_cwt),
    ("multiprocess", "diffsvc_tpu.utils.multiprocess",
     "diffsvc_tpu_torch.utils.multiprocess", _run_multiprocess),
    ("text_encoder", "diffsvc_tpu.utils.text_encoder",
     "diffsvc_tpu_torch.utils.text_encoder", _run_text_encoder),
    ("text_norm", "diffsvc_tpu.utils.text_norm",
     "diffsvc_tpu_torch.utils.text_norm", _run_text_norm),
], ids=["textgrid", "cwt", "multiprocess", "text_encoder", "text_norm"])
def test_numpy_copies_match_originals(tmp_path, name, original, copy, run):
    """The port's copies of the JAX package's numpy-only modules give the
    original's results, bit for bit, on the inputs of the JAX package's own
    tests of them (tests/test_textgrid.py, test_tools.py, test_legacy_
    modules.py, test_text_norm.py); each copy imports only the standard
    library and numpy."""
    want = run(importlib.import_module(original), tmp_path)
    got = run(importlib.import_module(copy), tmp_path)
    assert _same(got, want)
    mods = _imports(os.path.join(REPO, *copy.split(".")) + ".py")
    assert {m.split(".")[0] for m in mods} <= {
        "__future__", "re", "typing", "numpy", "multiprocessing",
        "traceback", "json"}, mods


def _run_loudness(mod, tmp):
    """tests/test_loudness.py's meter cases: the K-weighting at three
    rates, a full-scale 997 Hz sine, a tone with silence, a too-short and
    a silent input, and normalize_loudness to -22 LUFS."""
    out = [mod.k_weighting_coeffs(sr) for sr in (48000, 44100, 24000)]
    t = np.arange(48000) / 48000.0
    sine = np.sin(2 * np.pi * 997 * t)
    tone = 0.3 * np.sin(2 * np.pi * 220 * t)
    tone[12000:30000] = 0.0
    for wav, sr in ((sine, 48000), (tone, 48000), (tone[:4000], 48000),
                    (np.zeros(48000), 48000), (tone[::2], 24000)):
        out += [mod.integrated_loudness(wav, sr),
                mod.normalize_loudness(wav, sr, -22.0)]
    return out


def _run_trim(mod, tmp):
    """tests/test_loudness.py's trim cases: short and long gaps at 16 and
    44.1 kHz, with and without the -20 LUFS normalization, the energy gate
    alone, a pluggable detector."""
    out = []
    for sr, norm in ((16000, False), (44100, True)):
        t = np.arange(3 * sr) / sr
        wav = (0.3 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
        wav[int(0.5 * sr): int(0.7 * sr)] = 0.0
        wav[int(1.2 * sr): int(2.4 * sr)] = 0.0
        out += list(mod.trim_long_silences(wav, sr, norm=norm))
    pcm = (np.sin(np.arange(480) / 3.0) * 2000).astype(np.int16)
    out += [mod._energy_vad(pcm, -40.0), mod._energy_vad(pcm // 100, -40.0)]
    out += list(mod.trim_long_silences(
        out[0], 16000, vad_fn=lambda w: bool(w.max() > 3000)))
    return out


@pytest.mark.parametrize("original,copy,run", [
    ("diffsvc_tpu.ops.loudness", "diffsvc_tpu_torch.ops.loudness",
     _run_loudness),
    ("diffsvc_tpu.utils.audio_io", "diffsvc_tpu_torch.utils.audio_io",
     _run_trim),
], ids=["loudness", "trim_long_silences"])
def test_loudness_and_trim_copies_match_originals(tmp_path, original, copy,
                                                  run):
    """The port's copies of ``ops/loudness.py`` and of ``_energy_vad`` /
    ``trim_long_silences`` give the original's results bit for bit; they
    import the standard library, numpy and scipy alone."""
    want = run(importlib.import_module(original), tmp_path)
    got = run(importlib.import_module(copy), tmp_path)
    assert _same(got, want)
    mods = _imports(os.path.join(REPO, *copy.split(".")) + ".py")
    assert {m.split(".")[0] for m in mods} <= {
        "__future__", "io", "os", "typing", "numpy", "scipy"}, mods
