"""A run whose timed path is broken underneath comes out not correct: an
answer altered where the program produces it (the song cells), a
training step that leaves its state unchanged, one that leaves half of
the batch out and takes the mean over the rest; and the control (the
reference one precision lower) fails the limits at this size too."""

import time

import numpy as np
import pytest

from benchmark import control, harness, run
from benchmark.reference import precision
from benchmark.tests import tiny


def tiny_run(cell, overrides, seconds=0.5):
    return run.run_cell(cell, 11, seconds, False, device="cpu",
                        overrides=dict(overrides, t_start=time.perf_counter()))


@pytest.mark.parametrize("cell", ["svc44k.song", "svc24k.song"])
def test_altered_answer(cell, monkeypatch):
    from diffsvc_tpu_torch import infer_cli

    real = infer_cli.save_wav

    def altered(wav, path, sr, norm=False):
        wav = np.asarray(wav, np.float32).copy()
        wav[len(wav) // 3: len(wav) // 2] *= 0.5
        return real(wav, path, sr, norm)

    monkeypatch.setattr(infer_cli, "save_wav", altered)
    res = tiny_run(cell, tiny.song_overrides(cell))
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_unchanged_state(monkeypatch):
    from diffsvc_tpu_torch.training import task

    def no_update(self, grads):
        self.step += 1
        return self.lr_schedule(0)

    monkeypatch.setattr(task.Optimized, "apply_grads", no_update)
    res = tiny_run("svc44k.train", tiny.train_overrides(), 1.0)
    assert res["correct"] is False
    assert res["checks"]["update_gap"]["value"] > 0.99


def test_half_batch(monkeypatch):
    from diffsvc_tpu_torch.training import task

    real = task.SVCTask.loss_and_grads

    def half(self, batch, **kw):
        n = int(np.shape(batch["mels"])[0])
        mask = np.ones(n, np.float32)
        mask[n // 2:] = 0.0
        return real(self, dict(batch, sample_mask=mask), **kw)

    monkeypatch.setattr(task.SVCTask, "loss_and_grads", half)
    res = tiny_run("svc44k.train", tiny.train_overrides(), 1.0)
    assert res["correct"] is False


@pytest.mark.parametrize("cell", ["svc44k.song", "svc24k.song"])
def test_song_control_fails(cell):
    ov = tiny.song_overrides(cell)
    ov["workload"]["check"] = dict(ov["workload"]["check"], control_songs=2)
    lines = control.control_lines(cell, 11, "cpu", overrides=ov)
    assert [ln["control"] for ln in lines] == ["lowered"]
    assert lines[0]["correct"] is False
    assert any(c["value"] > c["limit"] for c in lines[0]["checks"].values())


def test_train_control_fails():
    # the CPU has no TF32: the stated f32's next step down here is bf16
    # operands (the chip's control turns TF32 on)
    train = harness.load_module("entries", "train")
    ov = tiny.train_overrides()
    ref = train.reference_steps(ov["workload"], ov["config"], ov["traffic"],
                                11, "cpu")
    with precision.lowered({"denoiser": "f32", "conditioner": "f32"}):
        low = train.reference_steps(ov["workload"], ov["config"],
                                    ov["traffic"], 11, "cpu")
    got = train.compare(ref, low["losses"], low["grad1"], ref["theta0"],
                        low["params"])
    lim = ov["workload"]["check"]["limits"]
    assert any(got[k] > lim[k] for k in lim)
