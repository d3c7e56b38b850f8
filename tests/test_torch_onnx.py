"""The port's ONNX export (diffsvc_tpu_torch/onnx, onnx_export) against the
JAX package's (diffsvc_tpu/onnx, onnx_export.py) on the CPU.

One tiny project (the JAX tests' ``_tiny_hp``: 8 mel, hidden 16, 4 layers
x 16 channels, K = 20; an NSF-HiFiGAN of 32 initial channels) with random
weights from seeds, written in the reference's layout: the port's CLI
exports it, and the JAX package exports the same files, its params read
from them by ``diffsvc_tpu/utils/convert_torch.py`` (the NSF vocoder by its
own loader), once per module.  The graphs are held against each other:
bytes through both wire codecs, interfaces, outputs within 1e-5 relative
L2 at the trace length and at another one, and the exported chain against
the port's in-process samplers and JAX's chain.  The converter is held
against eager torch on small programs (rtol 1e-5 / atol 1e-6, the
tolerance of tests/test_onnx_export.py).
"""

import ast
import inspect
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from diffsvc_tpu.config import HParams
from diffsvc_tpu.onnx import builder as jbuilder
from diffsvc_tpu.onnx import onnx_pb2
from diffsvc_tpu.onnx import proto as JP
from diffsvc_tpu.onnx import runtime as jruntime
from diffsvc_tpu.onnx import svc_export as jexport
from diffsvc_tpu.utils import convert_torch as cvt
from diffsvc_tpu_torch import onnx_export
from diffsvc_tpu_torch.models import diffnet
from diffsvc_tpu_torch.models.diffusion import GaussianDiffusion
from diffsvc_tpu_torch.onnx import builder as tbuilder
from diffsvc_tpu_torch.onnx import chain as tchain
from diffsvc_tpu_torch.onnx import runtime as truntime
from diffsvc_tpu_torch.onnx import svc_export as texport
from diffsvc_tpu_torch.onnx import wire
from diffsvc_tpu_torch.onnx.convert import export_onnx
from diffsvc_tpu_torch.utils import synth
from diffsvc_tpu_torch.vocoders import generator as TG
from diffsvc_tpu_torch.vocoders import istft_head as tih

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5
M, H = 8, 16

TINY = dict(
    audio_num_mel_bins=M, hidden_size=H, residual_layers=4,
    residual_channels=16, dilation_cycle_length=4, timesteps=20,
    K_step=20, diff_loss_type="l2", schedule_type="linear", max_beta=0.02,
    keep_bins=M, spec_min=[-6.0], spec_max=[1.5], no_fs2=True,
    use_pitch_embed=True, use_energy_embed=False, use_uv=False,
    pitch_norm="log", f0_bin=256, f0_min=50.0, f0_max=1100.0,
    pndm_speedup=5, audio_sample_rate=8000, sampler="dpmpp",
    sampler_clip_x0=1.0, vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN")
VOC = {"resblock": "1", "upsample_rates": [4, 4, 2],
       "upsample_kernel_sizes": [8, 8, 4], "upsample_initial_channel": 32,
       "resblock_kernel_sizes": [3, 5],
       "resblock_dilation_sizes": [[1, 3], [1, 3]], "num_mels": M,
       "sampling_rate": 8000}
ISTFT = dict(num_mels=M, dim=32, n_layers=2, n_fft=64, hop=16,
             sampling_rate=8000, use_f0=True, f0_bin=32)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def read(path) -> bytes:
    with open(path, "rb") as f:
        return f.read()


@pytest.fixture(scope="module")
def arts(tmp_path_factory):
    """The port's and the JAX package's artifact paths by stage ("t",
    "j") and the project: the port's CLI on a reference-layout project,
    the JAX package's exporters on the same files, plus the plain
    HiFi-GAN, the iSTFT head and a use_spk_id encoder exported by both."""
    root = str(tmp_path_factory.mktemp("onnx"))
    cfg_fn, ckpt = synth.write_project(os.path.join(root, "proj"), TINY, VOC)
    with open(cfg_fn) as f:
        hp = HParams(**yaml.safe_load(f))
    t_dir, j_dir = os.path.join(root, "port"), os.path.join(root, "jax")
    t = onnx_export.main(["--project", "proj", "--model", ckpt, "--config",
                          cfg_fn, "--out", t_dir, "--vocoder"])
    params = cvt.convert_gaussian_diffusion(ckpt, hp)
    j = jexport.export_svc_onnx(hp, params, j_dir, "proj")
    j.update(jexport.export_dpmpp_onnx(hp, j_dir, "proj", speedup=5))
    from diffsvc_tpu.vocoders.nsf_hifigan import load_model

    vparams, vcfg, _ = load_model(hp["vocoder_ckpt"])
    j["hifigan"] = jexport.export_vocoder_onnx(vcfg, vparams, j_dir, "proj")

    # the plain HiFi-GAN (no NSF source), from the port's state dict
    gen = TG.Generator(TG.HifiGanConfig.from_dict(dict(VOC, resblock="2"),
                                                  use_nsf=False))
    synth.randomize(gen, 7)
    t["plain"] = texport.export_vocoder_onnx(gen, t_dir, "plain")
    sd = {k: v.numpy() for k, v in gen.state_dict().items()}
    j["plain"] = jexport.export_vocoder_onnx(
        _jax_voc_cfg(gen.cfg), cvt.convert_hifigan_generator(sd, _jax_voc_cfg(
            gen.cfg)), j_dir, "plain")

    # the iSTFT head, through its .npz (either package reads it)
    from diffsvc_tpu.vocoders import istft_head as jih

    npz = os.path.join(root, "istft.npz")
    head = synth.write_istft(npz, tih.IstftVocoderConfig(**ISTFT), seed=8)
    t["istft"] = texport.export_istft_onnx(head, t_dir, "proj", t_mel=12)
    jcfg = jih.IstftVocoderConfig(**ISTFT)
    j["istft"] = jexport.export_istft_onnx(jcfg, jih.load_params(npz, jcfg),
                                           j_dir, "proj", t_mel=12)

    # the speaker-id encoder, from a reference-layout checkpoint
    hp_spk = HParams(**dict(TINY, use_spk_id=True, num_spk=3))
    model = GaussianDiffusion(hp_spk)
    synth.randomize(model, 9)
    spk_ckpt = os.path.join(root, "spk.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in
                               model.state_dict().items()}}, spk_ckpt)
    t["encoder_spk"] = texport.export_svc_onnx(
        hp_spk, model, os.path.join(t_dir, "spk"), "spk")["encoder"]
    j["encoder_spk"] = jexport.export_svc_onnx(
        hp_spk, cvt.convert_gaussian_diffusion(spk_ckpt, hp_spk),
        os.path.join(j_dir, "spk"), "spk")["encoder"]
    return {"t": t, "j": j, "hp": hp, "ckpt": ckpt, "t_dir": t_dir,
            "j_dir": j_dir}


def _jax_voc_cfg(cfg):
    from diffsvc_tpu.vocoders import generator as JG

    return JG.HifiGanConfig(**cfg._asdict())


STAGES = ["encoder", "denoise", "pred", "after", "dpmpp", "hifigan", "plain",
          "istft", "encoder_spk"]


def _inputs(stage, rng, length):
    """Seeded inputs of ``stage`` at T = ``length`` (T_ph = length - 1)."""
    T = length
    f32 = np.float32
    if stage in ("encoder", "encoder_spk"):
        spk = np.asarray([2 if stage == "encoder_spk" else 0], np.int64)
        mel2ph = rng.randint(0, T, (1, T)).astype(np.int64)
        return (rng.randn(1, T - 1, H).astype(f32), mel2ph, spk,
                (rng.rand(1, T) * 2 + 6).astype(f32))
    x = rng.randn(1, 1, M, T).astype(f32)
    if stage == "denoise":
        return x, np.asarray([13], np.int64), rng.randn(1, H, T).astype(f32)
    if stage == "pred":
        return (x, rng.randn(1, 1, M, T).astype(f32), np.asarray([15]),
                np.asarray([10]))
    if stage == "after":
        return (x,)
    if stage == "dpmpp":
        return (x, rng.randn(1, 1, M, T).astype(f32),
                rng.randn(1, 1, M, T).astype(f32), np.asarray([2]))
    if stage in ("hifigan", "plain"):
        mel = rng.randn(1, M, T).astype(f32)
        if stage == "plain":
            return (mel,)
        f0 = (rng.rand(1, T) * 200 + 100).astype(f32)
        f0[0, ::5] = 0.0
        return (mel, f0, rng.rand(1, 9).astype(f32),
                rng.randn(1, 9, T * 32).astype(f32))
    if stage == "istft":
        f0 = (rng.rand(1, 12) * 300 + 80).astype(f32)
        f0[0, ::4] = 0.0
        return rng.randn(1, 12, M).astype(f32) - 2.0, f0
    raise KeyError(stage)


# --- 1. the wire format -----------------------------------------------------

def _descriptor_fields(desc):
    types = {1: "double", 2: "float", 3: "int64", 4: "uint64", 5: "int32",
             9: "string", 11: "msg", 12: "bytes", 14: "enum"}
    out = {}
    for f in desc.fields:
        msg = f.message_type.full_name.split(".", 1)[1] if f.message_type \
            else None
        oneof = f.containing_oneof.name if f.containing_oneof else None
        repeated = f.is_repeated
        out[f.name] = (f.number, types[f.type], repeated, msg, oneof)
    return out


@pytest.mark.parametrize("name", sorted(
    n for n in wire._CLASSES))
def test_wire_fields_are_onnx_pb2s(name):
    """Every message of ``wire`` has the field numbers, kinds, labels,
    message types and oneofs of ``onnx_pb2``'s serialized descriptor."""
    desc = onnx_pb2.DESCRIPTOR.message_types_by_name[name.split(".")[0]]
    if "." in name:
        desc = desc.nested_types_by_name[name.split(".")[1]]
    want = _descriptor_fields(desc)
    got = {k: tuple(f) for k, f in wire._CLASSES[name]._fields.items()}
    assert got == want


@pytest.mark.parametrize("stage", STAGES)
def test_wire_bytes_both_ways(arts, stage):
    """A port artifact parses with the JAX package's protobuf bindings and
    a JAX artifact with the port's decoder; each re-serializes to the bytes
    it was read from, so both read the same nodes, initializers, value
    infos and opset."""
    for mine, other in ((arts["t"][stage], JP.ModelProto),
                        (arts["j"][stage], wire.ModelProto)):
        blob = read(mine)
        m = other()
        m.ParseFromString(blob)
        assert m.SerializeToString() == blob
        assert [(o.domain, o.version) for o in m.opset_import] == [("", 16)]
        assert m.ir_version == 8 and len(m.graph.node) > 0


def test_wire_scalars_and_unknown_fields():
    """Negative ints as 10-byte varints, float32 rounding, a oneof member
    at its default, packed and unpacked repeated ints, and a field the
    schema does not know, against protobuf."""
    def fill(P):
        a = P.AttributeProto()
        a.name, a.i, a.f, a.type = "a", -5, 0.1, P.AttributeProto.INTS
        a.ints.extend([-1, 3, 2 ** 40])
        a.floats.extend([0.1, -2.5])
        d = P.TensorShapeProto.Dimension()
        d.dim_value = 0
        return a, d

    (a1, d1), (a2, d2) = fill(wire), fill(JP)
    assert a1.SerializeToString() == a2.SerializeToString()
    assert d1.SerializeToString() == d2.SerializeToString() == b"\x08\x00"
    back = wire.AttributeProto()
    back.ParseFromString(a2.SerializeToString())
    assert (back.i, list(back.ints), back.f) == (-5, [-1, 3, 2 ** 40], a2.f)
    # field 8 unpacked (three varints) and an unknown field 99
    raw = b"\x40\x01\x40\x02\x40\x7f" + b"\x98\x06\x05" + b"\x0a\x01b"
    back.ParseFromString(raw)
    assert list(back.ints) == [1, 2, 127] and back.name == "b"


# --- 2. the copies of builder.py and runtime.py -------------------------------

def _defs(module):
    tree = ast.parse(inspect.getsource(module))
    return {n.name: ast.dump(n) for n in tree.body
            if isinstance(n, (ast.FunctionDef, ast.ClassDef))}


@pytest.mark.parametrize("copy,original", [(tbuilder, jbuilder),
                                           (truntime, jruntime)],
                         ids=["builder", "runtime"])
def test_copies_match_originals(copy, original):
    """Every function and class of the copy is the original's, statement
    for statement; only the docstring and the message module differ."""
    assert _defs(copy) == _defs(original)


@pytest.mark.parametrize("stage", STAGES)
def test_runtime_copy_bit_equal(arts, stage):
    """The port's runtime and the JAX OnnxRunner give bit-equal outputs on
    the port's graphs."""
    blob = read(arts["t"][stage])
    ins = _inputs(stage, np.random.RandomState(1), 13)
    got = truntime.OnnxRunner(blob)(*ins)
    want = jruntime.OnnxRunner(blob)(*ins)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# --- 3. the converter on small programs -----------------------------------------

class Conv(torch.nn.Module):
    def __init__(self, kind):
        super().__init__()
        self.kind = kind
        if kind == "dilated":
            self.c = torch.nn.Conv1d(6, 8, 3, padding=4, dilation=4)
        elif kind == "grouped":
            self.c = torch.nn.Conv1d(6, 9, 5, padding=2, groups=3, stride=2)
        else:
            self.c = torch.nn.ConvTranspose1d(6, 4, 8, stride=4, padding=2)

    def forward(self, x):
        return torch.nn.functional.leaky_relu(self.c(x), 0.1)


class LinearMish(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.a = torch.nn.Linear(6, 12)
        self.b = torch.nn.Linear(12, 5)

    def forward(self, x):
        return self.b(torch.nn.functional.mish(self.a(x)))


def _gather(x, idx):
    pad = torch.nn.functional.pad(x, (0, 0, 1, 0))
    return torch.gather(pad, 1, idx[:, :, None].expand(-1, -1, x.shape[-1]))


def _cat_slice(x):
    y = torch.cat([x[:, :, 1:], x[:, :, :1] * 2.0], dim=2)
    return y[:, ::2] - torch.tanh(y[:, 1::2, :-1].sum(dim=(1, 2),
                                                      keepdim=True))


def _cumsum_remainder(f0):
    # steps of 1/64: every partial sum is exact in f32, whatever the order
    # of accumulation (torch sums in f64 on the CPU, numpy in f32)
    ph = torch.remainder(torch.cumsum(torch.round(f0) / 64.0, dim=1), 1.0)
    return torch.where(f0 > 150.0, torch.sin(2 * np.pi * ph), ph - 0.5)


def _reshape(x):
    b, t, c = x.shape
    y = x.reshape(b, t * c).reshape(b, t, 2, c // 2).transpose(2, 3)
    return y.flatten(2) * torch.arange(t, dtype=x.dtype)[None, :, None]


def _program(name):
    """(module or function, input maker (rng, T) -> args, dynamic axes)."""
    def x3(c):
        return lambda rng, t: (torch.from_numpy(
            rng.randn(2, c, t).astype(np.float32)),)

    def btc(rng, t):
        return (torch.from_numpy(rng.randn(2, t, 6).astype(np.float32)),)

    if name in ("dilated", "grouped", "transposed"):
        return Conv(name), x3(6), {"x": [2]}
    if name == "linear_mish":
        return LinearMish(), btc, {"x": [1]}
    if name == "gather":
        def mk(rng, t):
            return (torch.from_numpy(rng.randn(1, t - 2, 6).astype(
                np.float32)), torch.from_numpy(rng.randint(
                    0, t - 1, (1, t))))
        return _gather, mk, {"x": [1], "idx": [1]}
    if name == "cat_slice":
        return _cat_slice, x3(5), {"x": [2]}
    if name == "cumsum_remainder":
        def mk(rng, t):
            return (torch.from_numpy((rng.rand(2, t) * 300 + 50).astype(
                np.float32)),)
        return _cumsum_remainder, mk, {"x": [1]}
    if name == "reshape":
        return _reshape, btc, {"x": [1]}
    raise KeyError(name)


PROGRAMS = ["dilated", "grouped", "transposed", "linear_mish", "gather",
            "cat_slice", "cumsum_remainder", "reshape"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("name", PROGRAMS)
def test_converter_matches_eager(name, seed):
    """The program exported at T = 11 runs through the port's runtime at
    T = 11 and at T = 23 to eager torch's numbers."""
    torch.manual_seed(seed)
    prog, make, dyn = _program(name)
    names = list(dyn)
    rng = np.random.RandomState(seed)
    blob = export_onnx(prog, make(rng, 11), input_names=names,
                       output_names=["y"], dynamic_axes=dyn)
    run = truntime.OnnxRunner(blob)
    for t in (11, 23):
        args = make(rng, t)
        with torch.no_grad():
            want = prog(*args).numpy()
        got = run(*[a.numpy() for a in args])[0]
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_trace_converts_again_with_replaced_weights():
    """One trace converted with a parameter replaced (``state``, the smoke's
    planted-fault route) equals a new export of the module with that
    parameter changed; a name the module lacks raises."""
    from diffsvc_tpu_torch.onnx.convert import trace

    torch.manual_seed(0)
    prog = Conv("dilated")
    args = (torch.randn(2, 6, 11),)
    tr = trace(prog, args, input_names=["x"], dynamic_axes={"x": [2]})
    zeros = torch.zeros_like(prog.c.bias)
    faulty = tr.onnx(["y"], state={"c.bias": zeros})
    assert tr.onnx(["y"]) != faulty
    with torch.no_grad():
        prog.c.bias.zero_()
    assert faulty == export_onnx(prog, args, input_names=["x"],
                                 output_names=["y"],
                                 dynamic_axes={"x": [2]})
    with pytest.raises(KeyError):
        tr.onnx(["y"], state={"c.nothing": zeros})


def test_converter_refuses_a_pinned_axis():
    """An axis asked to be dynamic that the program fixes is an error, not
    a graph of one length."""
    def pinned(x):
        return x * 2.0 if x.shape[1] == 7 else x

    with pytest.raises(Exception, match="dynamic|specializ|constant"):
        export_onnx(pinned, (torch.ones(1, 7),), input_names=["x"],
                    output_names=["y"], dynamic_axes={"x": [1]})


# --- 4. the artifacts against the JAX package's ------------------------------------

def _dims(v):
    return [d.dim_param or d.dim_value for d in v.type.tensor_type.shape.dim]


@pytest.mark.parametrize("stage", STAGES)
def test_artifact_matches_jax(arts, stage):
    """Graph name, input and output names, dtypes, input dims (with the
    JAX exporter's dim names), which output axes are dynamic, opset 16; and
    the outputs on the same seeded inputs within 1e-5 relative L2 of the
    JAX graph's, at the trace length (10) and at 13 (the iSTFT head: its
    fixed 12)."""
    t_run = truntime.OnnxRunner(read(arts["t"][stage]))
    j_run = jruntime.OnnxRunner(read(arts["j"][stage]))
    tg, jg = t_run.graph, j_run.graph
    assert tg.name == jg.name
    assert t_run.model.opset_import[0].version == 16
    assert [(v.name, v.type.tensor_type.elem_type, _dims(v))
            for v in tg.input] == [(v.name, v.type.tensor_type.elem_type,
                                    _dims(v)) for v in jg.input]
    for a, b in zip(tg.output, jg.output):
        assert (a.name, a.type.tensor_type.elem_type) == \
            (b.name, b.type.tensor_type.elem_type)
        assert [d if isinstance(d, int) else "dyn" for d in _dims(a)] == \
            [d if isinstance(d, int) else "dyn" for d in _dims(b)]
    assert len(tg.output) == len(jg.output)
    rng = np.random.RandomState(3)
    for length in ((12,) if stage == "istft" else (10, 13)):
        ins = _inputs(stage, rng, length)
        for a, b in zip(t_run(*ins), j_run(*ins)):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert rel(a, b) <= TOL, (stage, length, rel(a, b))


def test_dpmpp_meta_is_jaxs(arts):
    with open(arts["t"]["dpmpp_meta"]) as f, \
            open(arts["j"]["dpmpp_meta"]) as g:
        assert json.load(f) == json.load(g)


def test_speaker_id_moves_the_condition(arts):
    run = truntime.OnnxRunner(read(arts["t"]["encoder_spk"]))
    ins = list(_inputs("encoder_spk", np.random.RandomState(4), 9))
    a = run(*ins)[0]
    ins[2] = np.asarray([0], np.int64)
    assert np.abs(a - run(*ins)[0]).max() > 1e-3


def test_plain_route_is_serving_on_the_cpu(arts):
    """``diffnet.apply(plain=True)``, the exporter's route, is the serving
    route's numbers bit for bit on the CPU (where serving runs K1's plain
    version on the cached weights)."""
    model = texport.load_model(arts["ckpt"], arts["hp"])
    rng = np.random.RandomState(5)
    spec = torch.from_numpy(rng.randn(2, 17, M).astype(np.float32))
    cond = torch.from_numpy(rng.randn(2, 17, H).astype(np.float32))
    t = torch.tensor([3, 19])
    with torch.no_grad():
        a = diffnet.apply(model.denoise_fn, spec, t, cond)
        b = diffnet.apply(model.denoise_fn, spec, t, cond, plain=True)
    assert torch.equal(a, b)


def test_plain_route_refuses_other_devices(arts):
    """The plain route is the CPU trace's alone: on tensors elsewhere it
    raises rather than skip K1."""
    model = texport.load_model(arts["ckpt"], arts["hp"])
    spec = torch.zeros(1, 5, M, device="meta")
    with pytest.raises(ValueError, match="plain=True"):
        diffnet.apply(model.denoise_fn, spec, torch.tensor([3]),
                      torch.zeros(1, 5, H), plain=True)


# --- 5. the chain against the port's in-process sampler -----------------------------

def _feats(seed, t_ph=7, t=12):
    rng = np.random.RandomState(seed)
    return {"hubert": rng.randn(1, t_ph, H).astype(np.float32),
            "mel2ph": rng.randint(1, t_ph + 1, (1, t)).astype(np.int64),
            "f0": (rng.rand(1, t) * 2 + 6).astype(np.float32),
            "noise": rng.randn(1, 1, M, t).astype(np.float32)}


def _infer(arts, feats, **hp_over):
    hp = HParams(**dict(arts["hp"], **hp_over))
    model = texport.load_model(arts["ckpt"], hp)
    batch = {k: torch.from_numpy(feats[k]) for k in ("hubert", "mel2ph",
                                                     "f0")}
    out = model.infer(batch, init_noise=torch.from_numpy(
        feats["noise"][:, 0].transpose(0, 2, 1).copy()))
    return out["mel_out"].numpy().transpose(0, 2, 1) * np.log(10.0), \
        out["f0_denorm"].numpy()


@pytest.mark.parametrize("sampler,clip", [("plms", 0.0), ("dpmpp", 1.0),
                                          ("dpmpp", 0.0)])
def test_chain_matches_in_process_sampler(arts, tmp_path, sampler, clip):
    """``onnx.chain`` over the port's artifacts (the exported-graph PLMS
    loop, or the DPM-Solver++ step graph with and without x0 clipping)
    against ``GaussianDiffusion.infer`` (K2's plain version) from the same
    x_T, and against the JAX package's chain over its artifacts."""
    hp = arts["hp"]
    art, j_art = arts["t_dir"], arts["j_dir"]
    if sampler == "dpmpp" and clip == 0.0:
        hp0 = HParams(**dict(hp, sampler_clip_x0=0.0))
        art, j_art = str(tmp_path / "t"), str(tmp_path / "j")
        for d, src, fn in ((art, arts["t_dir"], texport.export_dpmpp_onnx),
                           (j_art, arts["j_dir"], jexport.export_dpmpp_onnx)):
            os.makedirs(d)
            for stage in ("encoder", "denoise", "pred", "after"):
                os.symlink(os.path.join(src, f"proj_{stage}.onnx"),
                           os.path.join(d, f"proj_{stage}.onnx"))
            fn(hp0, d, "proj", speedup=5)
    feats = _feats(11)
    mel, f0_pred, _ = tchain.run_chain(art, "proj", feats, k_step=20, acc=5,
                                       sampler=sampler)
    want, f0_want = _infer(arts, feats, sampler=sampler,
                           sampler_clip_x0=clip)
    np.testing.assert_allclose(mel, want, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f0_pred, f0_want, rtol=1e-4, atol=1e-3)
    sys.path.insert(0, REPO)
    from tools.run_onnx_chain import run_chain

    j_mel, _, _ = run_chain(j_art, "proj", feats, k_step=20, acc=5,
                            sampler=sampler)
    np.testing.assert_allclose(mel, j_mel, rtol=1e-4, atol=1e-4)


def test_chain_vocoder_stage(arts, tmp_path):
    """The chain's vocoder stage (``rand_ini``/``noise`` drawn from seed+1,
    L from the doc string's total_up) against ``generator.apply`` on the
    same draws, and the CLI form writing mel.npy and wav.npy."""
    from diffsvc_tpu_torch.vocoders.nsf_hifigan import load_model

    feats = _feats(12, t_ph=6, t=11)
    mel, f0_pred, wav = tchain.run_chain(arts["t_dir"], "proj", feats,
                                         k_step=20, acc=5)
    assert wav.shape == (1, 11 * 32)
    gen, _, _ = load_model(arts["hp"]["vocoder_ckpt"])
    rng = np.random.RandomState(1)
    ri, nz = rng.rand(1, 9).astype(np.float32), rng.randn(1, 9, 352).astype(
        np.float32)
    with torch.no_grad():
        want = TG.apply(gen, torch.from_numpy(mel.transpose(0, 2, 1).copy()),
                        torch.from_numpy(f0_pred),
                        (torch.from_numpy(ri), torch.from_numpy(nz)))
    assert rel(wav, want.numpy()) <= 1e-4
    np.savez(tmp_path / "f.npz", **feats)
    tchain.main(["--artifacts", arts["t_dir"], "--project", "proj",
                 "--features", str(tmp_path / "f.npz"), "--K_step", "20",
                 "--acc", "5", "--out", str(tmp_path / "o")])
    assert np.allclose(np.load(tmp_path / "o" / "wav.npy"), wav)


# --- 6. the CLI -----------------------------------------------------------------

def test_cli_writes_the_files(arts):
    names = sorted(os.listdir(arts["t_dir"]))
    assert {f"proj_{s}.onnx" for s in ("encoder", "denoise", "pred", "after",
                                       "dpmpp", "hifigan")} \
        | {"proj_dpmpp_meta.json"} <= set(names)


def test_cli_refuses_stablehlo(capsys):
    with pytest.raises(SystemExit) as e:
        onnx_export.main(["--project", "p", "--format", "stablehlo"])
    assert e.value.code == 2
    assert "XLA" in capsys.readouterr().err


def test_cli_exports_istft_head(tmp_path):
    """``--vocoder`` with the iSTFT head writes ``{proj}_istft.onnx`` at
    ``--t_mel``, and a plms config writes no dpmpp graph."""
    cfg = dict(TINY, sampler="plms", vocoder="IstftVocoder",
               fft_size=64, hop_size=16, istft_dim=32, istft_layers=1)
    cfg_fn, ckpt = synth.write_project(str(tmp_path / "p"), cfg, VOC)
    with open(cfg_fn) as f:
        full = yaml.safe_load(f)
    full["vocoder_ckpt"] = str(tmp_path / "istft.npz")
    with open(cfg_fn, "w") as f:
        yaml.safe_dump(full, f)
    synth.write_istft(full["vocoder_ckpt"], tih.IstftVocoderConfig(
        num_mels=M, dim=32, n_layers=1, n_fft=64, hop=16,
        sampling_rate=8000), seed=3)
    paths = onnx_export.main(["--project", "p", "--model", ckpt, "--config",
                              cfg_fn, "--out", str(tmp_path / "o"),
                              "--vocoder", "--t_mel", "9"])
    assert set(paths) == {"encoder", "denoise", "pred", "after", "istft"}
    run = truntime.OnnxRunner(read(paths["istft"]))
    mel = np.random.RandomState(0).randn(1, 9, M).astype(np.float32) - 2.0
    f0 = np.full((1, 9), 220.0, np.float32)
    assert run(mel, f0)[0].shape == (1, 9 * 16)


def test_jax_inputs_in_the_tiny_project(arts):
    """The JAX side reads the same weights: its denoise graph computes
    the JAX DiffNet on the converted params."""
    from diffsvc_tpu.models.diffusion import GaussianDiffusion as JGD

    hp = arts["hp"]
    model = JGD(hp)
    params = cvt.convert_gaussian_diffusion(arts["ckpt"], hp)
    x, t, cond = _inputs("denoise", np.random.RandomState(6), 10)
    want = model._dec.apply(params["denoise_fn"], model.net_cfg,
                            jnp.asarray(x[:, 0].transpose(0, 2, 1)),
                            jnp.asarray(t, jnp.int32),
                            cond=jnp.asarray(cond.transpose(0, 2, 1)))
    got = truntime.OnnxRunner(read(arts["t"]["denoise"]))(x, t, cond)[0]
    assert rel(got, np.asarray(want).transpose(0, 2, 1)[:, None]) <= TOL
