"""The port's spans and counters (``diffsvc_tpu_torch.utils.trace``) on the
CPU: the off path records nothing and opens no profiler range; nesting,
parents, requests and threads; the profiler's ``svc/<name>`` ranges; the
idle split by innermost span; the tree ``run_clip --batch_chunks`` records
on the tiny project, written by ``infer_cli --trace``; ``prefetch``'s
counters and the producer's spans."""

import json
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from _torch_fixtures import SR, TINY_HP, TINY_VOC, fake_units, voiced_wav
from diffsvc_tpu_torch import infer_cli
from diffsvc_tpu_torch.data.dataset import prefetch
from diffsvc_tpu_torch.infer import hubert_encoder
from diffsvc_tpu_torch.models.hubert import HubertConfig
from diffsvc_tpu_torch.utils import synth, trace
from diffsvc_tpu_torch.utils.audio_io import save_wav

TINY_HUB = HubertConfig(dim=32, num_heads=2, num_layers=2, ffn_dim=64,
                        proj_dim=32)


@pytest.fixture
def traced():
    """The process's buffer emptied, and tracing left off afterwards."""
    trace.reset()
    yield trace
    trace.disable()
    trace.reset()


def test_off_records_nothing_and_opens_no_range(traced, monkeypatch):
    def no_range(name):
        raise AssertionError(f"opened a profiler range {name}")

    monkeypatch.setattr(trace, "_profiler_range", no_range)
    assert not trace.on()
    ctx = trace.span("cli.song", n=1)
    assert ctx is trace.span("svc.batched")      # one shared no-op context
    with ctx:
        with trace.span("svc.pre"):
            trace.count("data.gets")
    assert trace.spans() == [] and trace.counters() == {}
    assert trace.dropped() == 0


def test_nesting_parent_request_thread(traced):
    trace.enable()
    with trace.span("cli.song", index=3) as root:
        with trace.span("cli.read"):
            pass
        with trace.span("svc.batched"):
            with trace.span("svc.pre"):
                trace.count("data.gets", 2)
    with trace.span("cli.song"):
        pass

    def producer():
        with trace.span("data.collate"):
            pass

    t = threading.Thread(target=producer)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    by = {}
    for s in trace.spans():
        by.setdefault(s.name, []).append(s)
    song = by["cli.song"][0]
    assert song.id == root.id and song.parent is None
    assert song.attrs == {"index": 3}
    assert by["cli.read"][0].parent == song.id
    assert by["svc.pre"][0].parent == by["svc.batched"][0].id
    assert {s.request for n in ("cli.read", "svc.batched", "svc.pre")
            for s in by[n]} == {song.request}
    assert by["cli.song"][1].request != song.request
    assert song.t0 <= by["cli.read"][0].t0 <= by["cli.read"][0].t1 \
        <= by["svc.pre"][0].t0 <= song.t1
    main = threading.get_ident()
    assert all(s.thread == main for n in ("cli.song", "svc.pre")
               for s in by[n])
    coll = by["data.collate"][0]
    assert coll.thread != main and coll.parent is None
    assert trace.counters() == {"data.gets": 2}


def test_bounded_buffer_counts_drops():
    tr = trace.Tracer(capacity=2)
    tr.enabled = True
    for _ in range(5):
        with tr.span("x"):
            pass
    assert len(tr.spans()) == 2 and tr.dropped == 3


def test_profiler_turns_tracing_on_with_named_ranges(traced):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.span("train.step"):
            with trace.span("train.forward"):
                torch.ones(4) + 1
        trace.count("data.gets")
    assert not trace.on()
    assert [s.name for s in trace.spans()] == ["train.forward", "train.step"]
    assert trace.counters() == {"data.gets": 1}
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"svc/train.step", "svc/train.forward"} <= names


def test_idle_split_gives_each_moment_to_the_innermost_span():
    S = trace.Span
    recs = [S(0, "a", 0.0, 10.0, None, 1, 0, {}),
            S(1, "b", 2.0, 4.0, 0, 1, 0, {}),
            S(2, "c", 3.0, 3.5, 1, 1, 0, {}),
            S(3, "d", 6.0, 9.0, 0, 1, 0, {}),
            S(4, "a", 12.0, 13.0, None, 1, 1, {})]
    # one gap crossing a, b, c, b, a, d; one inside d; one outside all
    split = trace.idle_split(recs, [(101.0, 107.0), (108.0, 108.5),
                                    (110.0, 112.5)], offset=100.0)
    want = {"a": 1.0 + 2.0 + 0.5, "b": 1.5, "c": 0.5, "d": 1.0 + 0.5,
            None: 2.0}
    assert split.keys() == want.keys()
    for k, v in want.items():
        assert split[k] == pytest.approx(v)


@pytest.fixture
def one_thread():
    """torch on one thread: the suite's workers share the cores, and a
    tiny conversion on every core of a loaded machine runs ten times
    slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def project(tmp_path_factory):
    root = tmp_path_factory.mktemp("torch_trace")
    config = dict(TINY_HP,
                  vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN")
    cfg_fn, ckpt = synth.write_project(str(root / "proj"), config, TINY_VOC,
                                       hubert_cfg=TINY_HUB)
    return root, cfg_fn, ckpt


@pytest.fixture
def song(project, monkeypatch, tmp_path):
    """A clip the slicer cuts in two, in the tiny project's directory, with
    the tiny HuBERT and its stand-in units."""
    root, _, _ = project
    monkeypatch.chdir(root)
    real = hubert_encoder.load
    monkeypatch.setattr(hubert_encoder, "load",
                        lambda path, device="cpu", cfg=None: real(
                            path, device, TINY_HUB))
    monkeypatch.setattr(hubert_encoder.Hubertencoder, "encode",
                        lambda self, w: fake_units(w))
    src = str(tmp_path / "song.wav")
    save_wav(voiced_wav(secs=6.0, f0=200.0, gaps=[(2.5, 3.2)]), src, SR)
    return src


def test_cli_trace_writes_the_song_tree(traced, one_thread, project, song,
                                        tmp_path):
    """``infer_cli --batch_chunks --trace PATH`` on a clip the slicer cuts:
    the run_clip tree (cli.* around svc.batched and its children), one
    request, written as Chrome-trace JSON; tracing off afterwards."""
    _, cfg_fn, ckpt = project
    src = song
    out = str(tmp_path / "trace.json")
    infer_cli.main(["--project", "proj", "--model", ckpt, "--config", cfg_fn,
                    "--files", src, "--acc", "10", "--device", "cpu",
                    "--no_crepe", "--batch_chunks", "--trace", out])
    assert not trace.on()
    spans = trace.spans()
    by_id = {s.id: s for s in spans}
    (song,) = [s for s in spans if s.name == "cli.song"]
    assert {s.request for s in spans} == {song.request}

    def parent(s):
        return by_id[s.parent].name if s.parent is not None else None

    kids = sorted(s.name for s in spans if s.parent == song.id)
    assert kids == sorted(["cli.read", "cli.slice", "cli.write", "cli.split",
                           "svc.batched", "cli.assemble", "cli.write"])
    (batched,) = [s for s in spans if s.name == "svc.batched"]
    split = next(s for s in spans if s.name == "cli.split")
    assemble = next(s for s in spans if s.name == "cli.assemble")
    assert split.t1 <= batched.t0 and batched.t1 <= assemble.t0
    n_pre = batched.attrs["inputs"]
    assert n_pre == 2
    for name, up, n in (("svc.pre", "svc.batched", n_pre),
                        ("svc.mel", "svc.pre", n_pre),
                        ("svc.f0", "svc.pre", n_pre),
                        ("svc.units", "svc.pre", n_pre),
                        ("svc.collate", "svc.pre", n_pre)):
        got = [s for s in spans if s.name == name]
        assert len(got) == n and {parent(s) for s in got} == {up}
    groups = [s for s in spans if s.name == "svc.upload"]
    assert sum(s.attrs["rows"] for s in groups) == n_pre
    for name in ("svc.upload", "svc.sample", "svc.vocode", "svc.download"):
        got = [s for s in spans if s.name == name]
        assert len(got) == len(groups) and {parent(s) for s in got} == {
            "svc.batched"}
    with open(out) as f:
        chrome = json.load(f)
    events = chrome["traceEvents"]
    assert sorted(e["name"] for e in events) == sorted(s.name for s in spans)
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in events)
    assert chrome["otherData"]["dropped"] == 0


def test_smoke_phase_sums_split_a_clip_by_span(traced, one_thread, project,
                                               song, tmp_path):
    """``chip_smoke.phase_sums`` (phase 4's and ``tools/conversion_turns``'
    host time by phase) around a per-chunk ``run_clip``: the block's time
    by innermost span, ``Svc.infer``'s front end, sampling and vocoder
    among them, and the buffer and the switch left as they were."""
    import chip_smoke
    from diffsvc_tpu_torch.infer.svc import Svc

    _, cfg_fn, ckpt = project
    svc = Svc("proj", cfg_fn, True, ckpt, device="cpu")
    t0 = time.perf_counter()
    with chip_smoke.phase_sums() as phases:
        infer_cli.run_clip(svc, key=0, acc=10, use_pe=False, use_crepe=False,
                           thre=0.05, use_gt_mel=False, add_noise_step=500,
                           file_path=song, out_path=str(tmp_path / "o.wav"))
    wall = time.perf_counter() - t0
    assert not trace.on() and trace.spans() == []
    # (no cli.slice where an earlier test left the clip's chunk cache)
    assert {"cli.read", "cli.split", "cli.assemble", "cli.write", "svc.mel",
            "svc.f0", "svc.units", "svc.collate", "svc.upload", "svc.sample",
            "svc.vocode"} <= phases.keys()
    assert all(v > 0 for v in phases.values())
    assert 0.9 * wall < sum(phases.values()) <= wall


def test_prefetch_counts_gets_and_records_the_producer(traced):
    def slow(n):
        for i in range(n):
            time.sleep(0.02)
            yield i

    trace.enable()
    got = list(prefetch(slow(4), prepare_fn=lambda x: x * 10, depth=1))
    assert got == [0, 10, 20, 30]
    counts = trace.counters()
    assert counts["data.gets"] == 4
    # the first get waits on a producer that sleeps before each item
    assert 1 <= counts["data.gets_empty"] <= 4
    coll = [s for s in trace.spans() if s.name == "data.collate"]
    # each item, and the step that finds the iterator's end
    assert len(coll) == 5
    assert all(s.thread != threading.get_ident() for s in coll)
    assert all(s.t1 - s.t0 >= 0.015 for s in coll[:4])
    t0, t1 = coll[0].t0, coll[-1].t1
    assert trace.counters(t1 + 1.0) == {}
    assert trace.counters(t0, time.perf_counter())["data.gets"] == 4
