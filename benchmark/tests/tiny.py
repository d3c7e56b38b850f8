"""Tiny widths of the cells for the CPU tests: the configuration files'
hparams with small networks at 8 kHz, a short song mix."""

from __future__ import annotations

import copy

from benchmark import harness

HP = dict(audio_sample_rate=8000, audio_num_mel_bins=16, keep_bins=16,
          fft_size=256, hop_size=64, win_size=256, fmin=40, fmax=4000,
          hidden_size=32, residual_layers=4, residual_channels=32,
          timesteps=50, K_step=50)
HUBERT = dict(dim=32, num_heads=2, num_layers=2, ffn_dim=64, proj_dim=32)
VOC = dict(num_mels=16, upsample_initial_channel=64, upsample_rates=[4, 4, 4],
           upsample_kernel_sizes=[8, 8, 8], resblock="1",
           resblock_kernel_sizes=[3, 5],
           resblock_dilation_sizes=[[1, 3], [1, 3]], sampling_rate=8000,
           n_fft=256, win_size=256, hop_size=64, fmin=40, fmax=4000,
           harmonic_num=8)


def config(name: str = "svc44k") -> dict:
    cfg = copy.deepcopy(harness.load_json("configs", name))
    cfg["hparams"].update(HP, f0_min=40.0)
    cfg["hubert"] = dict(HUBERT)
    cfg["vocoder"] = dict(VOC)
    return cfg


def song_mix(songs: int = 4) -> dict:
    mix = copy.deepcopy(harness.load_json("traffic", "songs"))
    mix["pool"].update(songs=songs, song_s=[9.0, 14.0], phrase_s=[2.0, 6.0])
    return mix


def fused_workload() -> dict:
    """The song entry's fused route as a workload: svc24k.song's file on
    svc44k's configuration through ``run_clip(fused=True)``, compared by
    its gap over the stated precision's (svc44k.song, the cell kept out
    of BENCHMARK.json until its check holds on every seed)."""
    wl = copy.deepcopy(harness.load_json("workloads", "svc24k.song"))
    wl.update(name="svc44k.song", config="svc44k")
    wl["entry_args"] = {"route": "fused", "acc": 20, "slice_db": -40}
    wl["check"] = dict(wl["check"], limits={"len_gap": 0,
                                            "gap_over_stated": 12.0})
    return wl


def song_overrides(cell: str = "svc44k.song", songs: int = 4) -> dict:
    wl = (fused_workload() if cell == "svc44k.song"
          else copy.deepcopy(harness.load_json("workloads", cell)))
    wl["entry_args"] = dict(wl["entry_args"], acc=10,
                            hubert_widths_from_config=True)
    return {"workload": wl, "config": config(wl["config"]),
            "traffic": song_mix(songs)}


def train_overrides(cell: str = "svc44k.train") -> dict:
    wl = copy.deepcopy(harness.load_json("workloads", cell))
    cfg = config(wl["config"])
    cfg["hparams"].update(max_sentences=4, max_tokens=4000)
    mix = copy.deepcopy(harness.load_json("traffic", wl["traffic"]))
    mix.update(items=16, frames=[40, 90])
    return {"workload": wl, "config": cfg, "traffic": mix}
