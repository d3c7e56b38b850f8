"""The port's device-time tools against the JAX repository's, on the CPU at
tiny widths: ``utils/devtime``'s FLOP counts against the JAX tools'
formulas (read from their sources) and the port DiffNet's weight shapes;
the smoke's helpers as the same objects; ``tools/mfu_decompose``,
``train_decompose``, ``bench_pipe_stages`` and ``bench_realtime`` with
``--device cpu``: the JAX tools' keys, legs, rows and bucket count, the
share guard against a timing window that ends early, the train parity
against a dropped cotangent."""

import ast
import json
import math
import os

import numpy as np
import pytest
import torch

import chip_smoke
from diffsvc_tpu_torch.utils import devtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MOVED = ("PEAK_BYTES", "PEAK_FLOPS", "bound", "cuda_time_ms",
         "device_events", "kernel_breakdown", "nbytes", "profile_run",
         "stack_flops", "tc_bound", "time_in_turns")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for this module (under xdist a pool of
    threads per worker oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_source(name: str) -> ast.Module:
    with open(os.path.join(REPO, "tools", f"{name}.py")) as f:
        return ast.parse(f.read())


def jax_formulas(name: str, targets, ns: dict) -> dict:
    """The values of the JAX tool's assignments to ``targets``, evaluated in
    source order over ``ns`` (each result added to it)."""
    ns = dict(ns)
    for node in ast.walk(jax_source(name)):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                and isinstance(node.targets[0], ast.Name) \
                and node.targets[0].id in targets:
            ns[node.targets[0].id] = eval(compile(
                ast.Expression(node.value), name, "eval"), {}, ns)
    return {k: ns[k] for k in targets}


@pytest.mark.parametrize("shape", [dict(B=24, T=1024, C=384, L=20, M=128,
                                        H=256),
                                   dict(B=3, T=896, C=256, L=7, M=80, H=192)],
                         ids=["production", "odd"])
def test_flop_counts_are_the_jax_tools(shape):
    """``tools/mfu_decompose.py:148-150`` (pad_T = T) and
    ``tools/train_decompose.py:125-127, 245`` evaluated from their sources,
    against ``devtime``'s counts at two shapes; the hardware count is the
    smoke's 60 C^2 per row and layer."""
    B, T, C, L, M, H = (shape[k] for k in "BTCLMH")
    mfu = jax_formulas("mfu_decompose", ("flops_kernel", "flops_step",
                                         "cond_once"),
                       dict(pad_T=T, C=C, L=L, M=M, H=H))
    train = jax_formulas("train_decompose", ("per_layer", "fwd_flops",
                                             "train_flops", "bwd_flops"),
                         dict(B=B, T=T, C=C, L=L))
    assert devtime.stack_flops(T, L, devtime.FWD_PER_ROW, C) \
        == mfu["flops_kernel"]
    assert devtime.eval_flops(T, C, L, M) == mfu["flops_step"]
    assert devtime.cond_flops(T, C, L, H) == mfu["cond_once"]
    assert devtime.stack_forward_flops(B, T, C, L) == train["fwd_flops"]
    assert devtime.train_model_flops(B, T, C, L) == train["train_flops"]
    assert devtime.backward_flops(B, T, C, L) == train["bwd_flops"]
    assert devtime.train_hardware_flops(B, T, C, L) \
        == devtime.stack_flops(B * T, L, 60, C) \
        == train["fwd_flops"] + train["bwd_flops"]
    assert devtime.train_model_flops(B, T, C, L) \
        == devtime.stack_flops(B * T, L, devtime.MODEL_PER_ROW, C)


def test_eval_flops_count_the_port_diffnet():
    """One evaluation's count from the port DiffNet's product weights:
    2 T (K N) per [K, N] weight that multiplies every row (input, the taps
    and output of every layer, skip and output projections)."""
    from diffsvc_tpu_torch.models.diffnet import DiffNet

    C, L, M, T = 48, 8, 24, 256
    p = DiffNet(in_dims=M, encoder_hidden=16, residual_layers=L,
                residual_channels=C).weights()
    per_row = (p["win"].numel() + p["wd"].numel() + p["wo"].numel()
               + p["wskip"].numel() + p["wout"].numel())
    assert devtime.eval_flops(T, C, L, M) == 2 * T * per_row


def test_smoke_imports_the_moved_helpers():
    for name in MOVED:
        assert getattr(chip_smoke, name) is getattr(devtime, name), name
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    defined = {n.name for n in ast.walk(ast.parse(src))
               if isinstance(n, ast.FunctionDef)}
    assert not defined & set(MOVED)


def test_share_guard():
    """989 GFLOP in 1 s is 1e-3 of the bf16 peak, in 1 ms all of it, in
    0.5 ms a timing fault."""
    assert devtime.share(989e9, 1000.0, "bf16") == pytest.approx(1e-3)
    assert devtime.share(989e9, 1.0, "bf16") == pytest.approx(1.0)
    with pytest.raises(devtime.TimingFault):
        devtime.share(989e9, 0.5, "bf16")
    with pytest.raises(devtime.TimingFault):
        devtime.share(1.0, 0.0, "bf16")


def jax_mfu_keys() -> set:
    """The keys the JAX tool writes (``results = {...}`` and every
    ``results["..."] =``)."""
    keys = set()
    for node in ast.walk(jax_source("mfu_decompose")):
        if isinstance(node, ast.Assign):
            t = node.targets[0]
            if isinstance(t, ast.Name) and t.id == "results" \
                    and isinstance(node.value, ast.Dict):
                keys |= {k.value for k in node.value.keys}
            if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name) \
                    and t.value.id == "results":
                keys.add(t.slice.value)
    return keys


def early_window(fn, reps):
    """A planted timing fault: the window closes before the work runs."""
    import time

    t0 = time.perf_counter()
    t1 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (t1 - t0) * 1e3 / reps


def test_mfu_decompose_on_the_cpu(tmp_path, monkeypatch):
    """The JAX tool's keys with null shares; finite cross-checks; K2 at f32
    (its plain version) against the f32 step-by-step loop within the port's
    K2 parity tolerance (``tests/test_torch_diffusion.py``: 3e-4 + 1e-4
    relative); shares read from a planted timing window that ends early
    raise, and the tool then writes nothing."""
    from diffsvc_tpu_torch.tools import mfu_decompose as mfu

    seen = {}
    time_levels = mfu.time_levels

    def kept(*a):
        seen["levels"] = time_levels(*a)
        return seen["levels"]

    monkeypatch.setattr(mfu, "time_levels", kept)
    monkeypatch.setattr(devtime, "host_time_ms", early_window)
    argv = ["--device", "cpu", "--iters", "1", "--loop-reps", "1",
            "--rounds", "1", "--out", str(tmp_path / "ok")]
    res = mfu.main(argv)
    assert jax_mfu_keys() <= set(res), jax_mfu_keys() - set(res)
    assert json.load(open(tmp_path / "ok" / "result.json")) == res
    shares = {k: v for k, v in res.items() if k.startswith("mfu_")}
    assert len(shares) == 7 and set(shares.values()) == {None}
    assert res["dims"]["evaluations"] == 51
    for k in ("ladder_vs_scan16_maxabs", "ladder_vs_fp32_meanabs",
              "scan16_vs_fp32_meanabs", "ladder32_vs_scan32_maxabs"):
        assert math.isfinite(res[k]), k
    ms, _, outs, _ = seen["levels"]
    np.testing.assert_allclose(outs["ladder32"], outs["fp32"], atol=3e-4,
                               rtol=1e-4)
    with pytest.raises(devtime.TimingFault):
        mfu.derive(ms, mfu.dims(True), card=True)
    monkeypatch.setattr(mfu, "measured_on_card", lambda device: True)
    monkeypatch.setattr(mfu, "time_levels", lambda *a: seen["levels"])
    with pytest.raises(devtime.TimingFault):
        mfu.main(argv[:-1] + [str(tmp_path / "fault")])
    assert not os.path.exists(tmp_path / "fault" / "result.json")


def jax_train_legs() -> list:
    names = []
    for node in ast.walk(jax_source("train_decompose")):
        if isinstance(node, ast.Assign) and isinstance(node.targets[0],
                                                       ast.Name) \
                and node.targets[0].id == "legs":
            names += [t.elts[0].value for t in node.value.elts]
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and node.value.startswith("train_step_"):
            names.append(node.value)
    return names


def test_train_decompose_on_the_cpu(tmp_path):
    """Every JAX leg (``tools/train_decompose.py:247-270``, the two steps)
    with its port route; null shares; the bf16 stream's grads against the
    scan's below the JAX tool's 2e-2."""
    from diffsvc_tpu_torch.tools import train_decompose as td

    res = td.main(["--device", "cpu", "--reps", "1", "--rounds", "1",
                   "--step-reps", "1", "--out", str(tmp_path)])
    legs = jax_train_legs()
    assert len(legs) == 11 and list(res["legs"]) == legs
    for name, leg in res["legs"].items():
        assert isinstance(leg["route"], str) and leg["route"], name
        assert leg["mfu_pct"] is None and leg["ms"] > 0, name
    assert set(res["parity_batched_vs_scan_relmax"]) == set(td.GRAD_NAMES)
    assert max(res["parity_batched_vs_scan_relmax"].values()) < 2e-2


def test_train_parity_sees_a_dropped_cotangent(monkeypatch):
    """Phase 3's K4 fault, the last sample's cotangent dropped, planted in
    the bf16 stream's backward: the parity reads above 2e-2."""
    from diffsvc_tpu_torch.ops.hopper import diffnet_stack_train as k4
    from diffsvc_tpu_torch.tools import train_decompose as td

    d = td.dims(None, True)
    *ops, dout = td.stack_operands(d, torch.device("cpu"))
    assert max(td.parity(tuple(ops), dout, d["CYC"]).values()) < 2e-2
    bwd = k4.residual_stack_train_batched_bwd

    def dropped(xsave, sb, cp, wd, bd, wo, dout, *, cycle):
        if wd.dtype == torch.bfloat16:
            dout = dout.clone()
            dout[-1] = 0
        return bwd(xsave, sb, cp, wd, bd, wo, dout, cycle=cycle)

    monkeypatch.setattr(k4, "residual_stack_train_batched_bwd", dropped)
    assert max(td.parity(tuple(ops), dout, d["CYC"]).values()) > 2e-2


def jax_pipe_rows() -> list:
    """The first argument of every ``timeit`` call of
    ``tools/bench_pipe_stages.py``, f-strings read at its SPEEDUP."""
    rows = []
    for node in ast.walk(jax_source("bench_pipe_stages")):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "timeit":
            rows.append(eval(compile(ast.Expression(node.args[0]), "rows",
                                     "eval"), {"SPEEDUP": 20}))
    return rows


def test_pipe_stages_rows_are_the_jax_rows():
    from diffsvc_tpu_torch.tools import bench_pipe_stages as ps

    res = ps.main(["--device", "cpu", "--runs", "1", "--k", "1"])
    names = [r["name"] for r in res["rows"]]
    assert names[:-1] == jax_pipe_rows()
    n44 = int(ps.SR * res["secs"])
    assert names[-1] == f"fetch {n44 * 4 / 1e6:.1f} MB wav out"
    assert all(r["ms"] > 0 for r in res["rows"][1:-1])


def jax_bucket_count(hp, durs, stream: bool, runs: int) -> int:
    """The length buckets the JAX tool's calls build, through the JAX
    ``FusedSvc.__call__``'s padding and the JAX streaming converter, with
    the program itself stubbed (``_get_fn`` records its length)."""
    from diffsvc_tpu.infer.fused import FusedSvc as JFused
    from diffsvc_tpu.infer.streaming import StreamingConverter
    from diffsvc_tpu_torch.tools.bench_realtime import make_buf

    lengths = set()
    j = object.__new__(JFused)
    j.hp = dict(hp)
    j.params = j.hub_params = None
    j._voc_run_params = lambda: None

    def get_fn(n44, use_gt_mel=False, add_noise_step=500):
        lengths.add(n44)
        return lambda *a: (np.zeros(n44, np.int16), np.zeros(1),
                           np.zeros((1, 1)))

    j._get_fn = get_fn
    sr = hp["audio_sample_rate"]
    for dur in durs:
        if stream:
            sc = StreamingConverter(
                lambda w: JFused.to_float(np.asarray(j(w)[0]))[:len(w)], sr,
                context_ms=100.0, crossfade_ms=40.0)
            for seed in range(runs + 2):
                sc(make_buf(dur, seed=seed))
        else:
            for seed in range(runs + 1):
                j(make_buf(dur, seed=seed))
    return len(lengths)


@pytest.mark.parametrize("mode", [["--profile", "gtmel"], ["--stream"]],
                         ids=["gtmel", "stream"])
def test_realtime_rows_and_buckets_match_jax(mode):
    """The JAX tool's row keys (less the tunnel probe's) and its bucket
    count for the same hparams and buffers."""
    from diffsvc_tpu_torch.tools import bench_realtime as rt
    from diffsvc_tpu_torch.tools.soak_serving import serving_hp, widths

    durs = (0.2, 0.5)
    res = rt.main(["--device", "cpu", "--runs", "1", "--durs",
                   ",".join(map(str, durs)), *mode])
    keys = {"dur_s", "cold_s", "p50_ms", "p95_ms", "rt_headroom"}
    for row in res["rows"]:
        assert keys <= set(row)
        assert ("pipe_p50_ms" in row) == (mode[0] != "--stream")
    hp = serving_hp(widths(True), 50,
                    fused_bucket_samples=res["bucket_samples"])
    assert res["n_buckets"] == jax_bucket_count(
        hp, durs, mode[0] == "--stream", 1) == (3 if mode[0] == "--stream"
                                                else 2)
