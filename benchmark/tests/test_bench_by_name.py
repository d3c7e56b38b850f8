"""A cell, a traffic mix and a per-layer metric added as new files alone
(in a copy of the benchmark) are found by name: no file of the harness is
edited."""

import json
import shutil
import time
from pathlib import Path

from benchmark import harness, run
from benchmark.tests import tiny

BENCH = Path(__file__).resolve().parents[1]


def test_new_files_found_by_name(tmp_path, capsys):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    spec = harness.bench_spec()
    # a new mix (data only), a new cell on it, a new per-layer reader
    mix = tiny.song_mix(3)
    mix["pool"]["song_s"] = [8.0, 10.0]
    (root / "benchmark/traffic/short_songs.json").write_text(json.dumps(mix))
    wl = dict(tiny.song_overrides()["workload"], name="svc44k.short",
              traffic="short_songs")
    (root / "benchmark/workloads/svc44k.short.json").write_text(
        json.dumps(wl))
    (root / "benchmark/metrics/songs.count.short.py").write_text(
        "def read(run):\n"
        "    return float(len(run.window_spans('song')))\n")
    spec["workloads"].append({"name": "svc44k.short", "config": "svc44k",
                              "traffic": "short_songs", "chips": 1,
                              "why": "a test cell"})
    for m in spec["end_to_end"]:
        if m["name"] == "song_audio_rate":
            m["workloads"].append("svc44k.short")
    spec["per_layer"].append({"name": "songs.count.short", "unit": "count",
                              "better": "higher", "source": "program_span",
                              "layer": "CLI and slicing",
                              "moves": "song_audio_rate",
                              "workloads": ["svc44k.short"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    cfg = tiny.config()
    for trace in (False, True):
        res = run.run_cell("svc44k.short", 3, 0.5, trace, device="cpu",
                           root=root / "benchmark",
                           overrides={"config": cfg,
                                      "t_start": time.perf_counter()})
        assert res["correct"] is True
        if trace:
            assert res["metrics"]["songs.count.short"]["value"] >= 1
        else:
            assert set(res["metrics"]) == {"song_audio_rate", "setup_s"}
