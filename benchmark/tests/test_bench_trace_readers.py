"""The readers of the program's spans and counters (``cli.idle.song``,
``svc.idle.song``, ``train.host_idle.train``, ``data.busy.train``,
``data.starved.train``) on synthetic runs: the exact split of idle gaps
that cross several spans, the window's cut, another thread's spans left
out, the failure on a card run whose window did the work with none of the
spans, and nothing read without a card trace or from a program without
the spans."""

import sys

import pytest

import diffsvc_tpu_torch.utils
from benchmark import harness
from benchmark.tests import tiny
from diffsvc_tpu_torch.utils import trace

S, C = trace.Span, trace.Count
MAIN, OTHER = 1, 2


def synthetic(cell, device, window, trace_window, busy, spans, counts=(),
              monkeypatch=None, work=({"kind": "x"},)):
    ov = (tiny.train_overrides() if cell.endswith(".train")
          else tiny.song_overrides(cell))
    r = harness.Run(cell, ov["workload"], ov["config"], ov["traffic"], 1,
                    1.0, True, device, 0.0)
    r.t0, r.t1 = window
    r.spans = [("window", r.t0, r.t1, {})]
    r.trace_window = trace_window
    r.device_events = [(a, b, "kernel") for a, b in busy]
    r.work = list(work)
    tr = trace.Tracer()
    tr._spans, tr._counts = list(spans), list(counts)
    monkeypatch.setattr(trace, "spans", tr.spans)
    monkeypatch.setattr(trace, "counters", tr.counters)
    return r


def song_spans():
    # perf clock; the window is [1000, 1010], the trace's [50, 60]
    return [S(0, "cli.song", 1000.5, 1009.5, None, MAIN, 7, {}),
            S(1, "cli.read", 1000.5, 1001.5, 0, MAIN, 7, {}),
            S(2, "cli.split", 1001.5, 1002.0, 0, MAIN, 7, {}),
            S(3, "svc.batched", 1002.0, 1008.0, 0, MAIN, 7, {}),
            S(4, "svc.pre", 1002.0, 1004.0, 3, MAIN, 7, {}),
            S(5, "svc.mel", 1002.0, 1003.0, 4, MAIN, 7, {}),
            S(6, "svc.sample", 1004.0, 1007.0, 3, MAIN, 7, {}),
            S(7, "svc.download", 1007.0, 1008.0, 3, MAIN, 7, {}),
            S(8, "cli.assemble", 1008.0, 1009.0, 0, MAIN, 7, {}),
            S(9, "cli.write", 1009.0, 1009.5, 0, MAIN, 7, {}),
            # another thread's span over everything, and an earlier run's
            S(10, "cli.song", 999.0, 1010.0, None, OTHER, 8, {}),
            S(11, "cli.song", 900.0, 905.0, None, MAIN, 1, {})]


SONG_BUSY = [(52.5, 53.0), (54.0, 57.0), (57.0, 57.5)]


@pytest.mark.parametrize("metric,want", [
    # idle: 50.5-52 read and split, 58-59.5 assembly and write
    ("cli.idle.song", 100.0 * (1.0 + 0.5 + 1.0 + 0.5) / 10),
    # idle: 52-52.5 mel, 53-54 the front end, 57.5-58 the download
    ("svc.idle.song", 100.0 * (0.5 + 1.0 + 0.5) / 10)])
def test_song_idle_split(metric, want, monkeypatch):
    r = synthetic("svc24k.song", "cuda", (1000.0, 1010.0), (50.0, 60.0),
                  SONG_BUSY, song_spans(), monkeypatch=monkeypatch)
    r.spans.append(("song", 1000.4, 1009.6, {}))
    assert harness.load_module("metrics", metric).read(r) == \
        pytest.approx(want)


def train_run(monkeypatch, spans=None, counts=None, device="cuda"):
    spans = [S(0, "train.step", 2000.0, 2004.0, None, MAIN, 1, {}),
             S(1, "train.upload", 2000.0, 2000.5, 0, MAIN, 1, {}),
             S(2, "train.forward", 2000.5, 2002.0, 0, MAIN, 1, {}),
             S(3, "train.backward", 2002.0, 2003.5, 0, MAIN, 1, {}),
             S(4, "train.optimizer", 2003.5, 2004.0, 0, MAIN, 1, {}),
             S(5, "train.step", 2005.0, 2009.0, None, MAIN, 2, {}),
             S(6, "data.collate", 1999.0, 2001.0, None, OTHER, 3, {}),
             S(7, "data.collate", 2003.0, 2004.5, None, OTHER, 4, {})] \
        if spans is None else spans
    counts = [C("data.gets", 1990.0, 1), C("data.gets_empty", 1990.0, 1),
              C("data.gets", 2000.1, 1), C("data.gets_empty", 2000.1, 1),
              C("data.gets", 2004.9, 1)] if counts is None else counts
    return synthetic("svc44k.train", device, (2000.0, 2010.0), (0.0, 10.0),
                     [(0.2, 0.5), (0.6, 3.8), (5.5, 9.0)], spans, counts,
                     monkeypatch=monkeypatch)


@pytest.mark.parametrize("metric,want", [
    # idle: 0-0.2 upload, 0.5-0.6 forward, 3.8-4 optimizer, 5-5.5 a step
    ("train.host_idle.train", 100.0 * (0.2 + 0.1 + 0.2 + 0.5) / 10),
    # the producer: 2000-2001 (cut to the window) and 2003-2004.5
    ("data.busy.train", 100.0 * (1.0 + 1.5) / 10),
    # inside the window: two gets, one of them on an empty queue
    ("data.starved.train", 50.0)])
def test_train_readers(metric, want, monkeypatch):
    got = harness.load_module("metrics", metric).read(train_run(monkeypatch))
    assert got == pytest.approx(want)


@pytest.mark.parametrize("metric", [
    "cli.idle.song", "svc.idle.song", "train.host_idle.train",
    "data.busy.train", "data.starved.train"])
def test_missing_spans_fail_a_card_run_that_did_the_work(metric, monkeypatch):
    if metric.endswith(".song"):
        r = synthetic("svc24k.song", "cuda", (1000.0, 1010.0), (50.0, 60.0),
                      SONG_BUSY, [], monkeypatch=monkeypatch)
        r.spans.append(("song", 1000.4, 1009.6, {}))
    else:
        r = train_run(monkeypatch, spans=[], counts=[])
    reader = harness.load_module("metrics", metric)
    with pytest.raises(RuntimeError, match="holds no|counted no"):
        reader.read(r)
    r.work = []
    r.spans = r.spans[:1]
    assert reader.read(r) is None


@pytest.mark.parametrize("metric", [
    "cli.idle.song", "svc.idle.song", "train.host_idle.train"])
def test_no_card_trace_reads_nothing(metric, monkeypatch):
    if metric.endswith(".song"):
        r = synthetic("svc24k.song", "cpu", (1000.0, 1010.0), (50.0, 60.0),
                      SONG_BUSY, song_spans(), monkeypatch=monkeypatch)
    else:
        r = train_run(monkeypatch, device="cpu")
    assert harness.load_module("metrics", metric).read(r) is None


@pytest.mark.parametrize("metric", [
    "cli.idle.song", "svc.idle.song", "train.host_idle.train",
    "data.busy.train", "data.starved.train"])
def test_a_program_without_the_spans_reads_nothing(metric, monkeypatch):
    r = (synthetic("svc24k.song", "cuda", (1000.0, 1010.0), (50.0, 60.0),
                   SONG_BUSY, [], monkeypatch=monkeypatch)
         if metric.endswith(".song") else train_run(monkeypatch, [], []))
    monkeypatch.delattr(diffsvc_tpu_torch.utils, "trace")
    monkeypatch.setitem(sys.modules, "diffsvc_tpu_torch.utils.trace", None)
    assert harness.load_module("metrics", metric).read(r) is None
