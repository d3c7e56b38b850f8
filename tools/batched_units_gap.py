#!/usr/bin/env python3
"""How far the batched binarizer's HuBERT units are from the per-item
encoder's, in the JAX package and in the port, on the CPU.

    JAX_PLATFORMS=cpu python3 tools/batched_units_gap.py [--clips 4]

Both packages load the same HuBERT-soft checkpoint (768 x 12, random
weights from a seed, ``diffsvc_tpu_torch.utils.synth.write_hubert``) and
encode the same synthetic 44.1 kHz clips (config_44k's geometry) two ways:

- per item, ``Hubertencoder.encode(path)``: the 16 kHz load padded to
  0.4 s multiples;
- batched, as ``features.process_items_batched`` does: the wav padded to
  its ``wav_bucket_frames * hop_size`` bucket at 44.1 kHz, resampled to 16
  kHz on the host, ``encode_batch``, trimmed to the item's unit count.

The attention is unmasked, so the units see other padding.  Prints one
line per clip and, last, one JSON line with each package's rel-L2 (mean
and max over the clips).
"""

import argparse
import json
import os
import sys
import tempfile

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SR, HOP, BUCKET_FRAMES = 44100, 512, 128


def batched_units(enc, audio_io, wav_fn):
    wav, _ = audio_io.load_wav_nsf(wav_fn, target_sr=SR)
    bucket = BUCKET_FRAMES * HOP
    pad_len = -(-len(wav) // bucket) * bucket
    wav16 = audio_io.resample(np.pad(wav, (0, pad_len - len(wav))), SR,
                              16000)
    true_units = max(int(len(wav) * 16000 / SR) // 320, 1)
    return np.asarray(enc.encode_batch(wav16[None]))[0][:true_units]


def rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--clips", type=int, default=4)
    args = ap.parse_args(argv)

    import jax

    jax.config.update("jax_platforms", "cpu")
    from diffsvc_tpu.infer import hubert_encoder as jenc
    from diffsvc_tpu.utils import audio_io as jaio
    from diffsvc_tpu_torch.infer import hubert_encoder as tenc
    from diffsvc_tpu_torch.models.hubert import HubertConfig
    from diffsvc_tpu_torch.utils import audio_io as taio
    from diffsvc_tpu_torch.utils import synth

    with tempfile.TemporaryDirectory() as tmp:
        pt = os.path.join(tmp, "hubert_soft.pt")
        synth.write_hubert(pt, HubertConfig(), seed=2)
        encoders = {"jax": (jenc.Hubertencoder(pt), jaio),
                    "torch": (tenc.Hubertencoder(pt, device="cpu"), taio)}
        gaps = {k: [] for k in encoders}
        for i, secs in enumerate(np.linspace(4.0, 7.0, args.clips)):
            fn = os.path.join(tmp, f"clip{i}.wav")
            taio.save_wav(synth.voiced_wav(float(secs), SR, 150.0 + 20 * i,
                                           seed=i), fn, SR)
            for name, (enc, aio) in encoders.items():
                per_item = np.asarray(enc.encode(fn))
                batched = batched_units(enc, aio, fn)
                if per_item.shape != batched.shape:
                    raise SystemExit(f"{name} clip {i}: per-item units "
                                     f"{per_item.shape}, batched "
                                     f"{batched.shape}")
                gaps[name].append(rel_l2(batched, per_item))
            print(f"clip {i} ({secs:.2f} s): units rel_l2 batched vs per "
                  f"item: jax {gaps['jax'][-1]:.4e}, torch "
                  f"{gaps['torch'][-1]:.4e}", flush=True)
    print(json.dumps({name: {"mean": float(np.mean(g)), "max": float(max(g)),
                             "clips": len(g)} for name, g in gaps.items()}))


if __name__ == "__main__":
    main()
