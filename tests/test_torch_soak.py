"""The port's serving soak (``diffsvc_tpu_torch/tools/soak_serving.py``)
against the JAX repository's ``tools/soak_serving.py`` on the CPU at tiny
widths: the same synthetic uploads and percentiles, both legs through the
port's HTTP stack with no error and no program built after warm-up, and a
warm-up to a shorter buffer than the mix needs read as programs built
after it."""

import importlib.util
import os

import numpy as np
import pytest
import torch

from diffsvc_tpu_torch.tools import soak_serving as soak

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one intra-op thread for this module (under xdist a pool of
    threads per worker oversubscribes the cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_tool(name: str):
    """``tools/<name>.py`` of the JAX repository under a private name; the
    soak imports no JAX at module level (``:29-38``)."""
    spec = importlib.util.spec_from_file_location(
        f"_jax_tools_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dur,sr,seed", [(0.2, 44100, 0), (1.0, 44100, 7),
                                         (0.35, 16000, 123)])
def test_uploads_and_percentiles_are_the_jax_tools(dur, sr, seed):
    jt = jax_tool("soak_serving")
    assert soak.make_wav_bytes(dur, sr, seed) == jt.make_wav_bytes(dur, sr,
                                                                    seed)
    xs = list(np.random.RandomState(seed).rand(17))
    for q in (50, 95, 99):
        assert soak.pct(xs, q) == jt.pct(xs, q)
    assert soak.pct([], 50) is jt.pct([], 50) is None


def test_soak_both_legs(tmp_path):
    """A 3 s soak of each leg: requests answered, 0 errors (every answer a
    200 whose wav has the posted buffer's length), 0 programs built after
    warm-up."""
    res = soak.main(["--device", "cpu", "--minutes", "0.05", "--durs",
                     "0.2,0.5", "--out", str(tmp_path)])
    assert os.path.exists(tmp_path / "summary.json")
    assert res["warmup_buckets"] == 2 and res["warmup_max_s"] == 0.7
    for name, leg in res["legs"].items():
        assert leg["requests"] > 0 and leg["errors"] == 0, (name, leg)
        assert leg["recompiles_after_warmup"] == 0, (name, leg)
        assert leg["fns_growth"] == 0 and leg["first_errors"] == []
    assert set(res["legs"]["nonstream"]["per_dur"]) == {"0.2", "0.5"}


def test_short_warmup_reads_programs_built(tmp_path):
    """The planted fault: a warm-up up to 0.2 s for a mix whose 0.5 s
    buffers need a second bucket; the leg builds it."""
    res = soak.main(["--device", "cpu", "--minutes", "0.01", "--durs",
                     "0.2,0.5", "--warmup-seconds", "0.2", "--out",
                     str(tmp_path)])
    assert res["warmup_buckets"] == 1
    assert res["legs"]["nonstream"]["recompiles_after_warmup"] >= 1
    assert res["legs"]["nonstream"]["errors"] == 0
