"""A run of the harness at tiny widths on the CPU: its last line meets
the contract, the JAX stack and the JAX package stay unloaded, and the
command refuses to print a result without a card."""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

from benchmark import harness, run
from benchmark.tests import tiny

ROOT = Path(__file__).resolve().parents[2]


def tiny_run(cell, overrides, trace=False, seconds=0.5, seed=123456789012):
    return run.run_cell(cell, seed, seconds, trace, device="cpu",
                        overrides=dict(overrides, t_start=time.perf_counter()))


def check_line(line: str, cell: str, trace: bool):
    res = json.loads(line)
    assert list(res)[-1] == "checks"
    for k in ("correct", "attempted", "failed", "metrics", "device"):
        assert k in res
    assert res["correct"] is True and res["failed"] == 0
    assert res["attempted"] > 0
    e2e, layer = harness.cell_metrics(harness.bench_spec(ROOT), cell)
    assert set(res["metrics"]) <= set(layer if trace else e2e)
    if not trace:
        assert set(res["metrics"]) == set(e2e)
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"}
    for c in res["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    return res


@pytest.mark.parametrize("cell,trace", [("svc24k.song", False),
                                        ("svc24k.song", True),
                                        ("svc44k.song", False)])
def test_song_line(cell, trace, capsys):
    harness.emit(tiny_run(cell, tiny.song_overrides(cell), trace))
    out = capsys.readouterr()
    res = check_line(out.out.strip().splitlines()[-1], cell, trace)
    last = out.err.strip().splitlines()[-len(res["checks"]):]
    assert [ln.split()[1] for ln in last] == list(res["checks"])
    if trace:
        assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "busy_s" in res["device"] and "window_s" in res["device"]


@pytest.mark.parametrize("trace", [False, True])
def test_train_line(trace, capsys):
    harness.emit(tiny_run("svc44k.train", tiny.train_overrides(), trace,
                          seconds=1.0))
    check_line(capsys.readouterr().out.strip().splitlines()[-1],
               "svc44k.train", trace)


def test_no_jax_loaded():
    code = ("import time, sys; from benchmark import run, harness; "
            "from benchmark.tests import tiny; "
            "run.run_cell('svc24k.song', 3, 0.5, False, device='cpu', "
            "overrides=dict(tiny.song_overrides('svc24k.song'), "
            "t_start=time.perf_counter())); "
            "print('LOADED', harness.forbidden_loaded(), "
            "'diffsvc_tpu_torch' in sys.modules)")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    last = res.stdout.strip().splitlines()[-1]
    assert last == "LOADED [] True"


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    res = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload", "svc24k.song",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, BENCH_RUN="1"))
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.parametrize("metric,cell,work", [
    ("k2.roofline.song", "svc44k.song", {"kind": "infer_fused", "n": 40000}),
    ("k3.roofline.song", "svc24k.song", {"kind": "infer_batched",
                                         "ns": [30000, 31000]}),
    ("stack.roofline.train", "svc44k.train",
     {"kind": "step", "rows": 2, "frames": 128, "lengths": [100, 90]})])
def test_roofline_without_its_kernels_fails(metric, cell, work):
    # a card trace of a window that did the family's work, with none of
    # its kernels in it: renamed or replaced kernels fail the run
    ov = (tiny.train_overrides() if cell.endswith(".train")
          else tiny.song_overrides(cell))
    r = harness.Run(cell, ov["workload"], ov["config"], ov["traffic"], 1,
                    1.0, True, "cuda", 0.0)
    r.work = [work]
    r.device_events = [(0.0, 0.5, "void other::kernel<float>()")]
    reader = harness.load_module("metrics", metric)
    with pytest.raises(RuntimeError, match="none of its kernels"):
        reader.read(r)
    r.work = []
    assert reader.read(r) is None
