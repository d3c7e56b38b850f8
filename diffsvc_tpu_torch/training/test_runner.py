"""Test-split inference (``run.py --infer``): full sampling over the test
set with wav / plot / npy artifacts.

Counterpart of ``diffsvc_tpu/training/test_runner.py`` (reference
``FastSpeech2Task.test_step/after_infer/save_result``, training/task/
fs2.py:354-525): per item, at ``max_sentences`` 1 and padded to
``frames_multiple``, sample (the SVC task through K2, with the EMA weights
when kept), clip the nonpadded mel frames to [mel_vmin, mel_vmax], render
``spec2wav(mel, f0=f0_pred)`` (K3) and save ``[P][item].wav`` / ``.png``
under ``generated_<step>_<gen_dir_name>`` and the mel under
``P_mels_npy``; with ``save_gt`` the ground truth as ``[G]`` too.  Without
a vocoder only the mels are saved.  Every device call stays on this
thread; the artifact threads only write files.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..data.batching import batch_by_size
from ..data.dataset import BatchIterator, FastSpeechDataset
from ..ops.pitch import denorm_f0
from ..utils.audio_io import save_wav
from ..utils.plot import spec_to_figure


def save_result(wav_out, mel, prefix, item_name, gen_dir, work_dir, sr):
    item_name = str(item_name).replace("/", "-")
    base_fn = f"[{prefix}][{item_name}]"
    save_wav(wav_out, f"{gen_dir}/wavs/{base_fn}.wav", sr)
    np.save(os.path.join(work_dir, f"{prefix}_mels_npy", item_name), mel)
    try:    # a pyplot-free Figure: safe inside the artifact threads
        spec_to_figure(mel).savefig(f"{gen_dir}/plot/{base_fn}.png",
                                    format="png")
    except Exception as e:
        print(f"| plot failed: {e}")


def _nonpadded(mel, hp):
    mask = np.abs(mel).sum(-1) > 0
    return np.clip(mel[mask], hp["mel_vmin"], hp["mel_vmax"]), mask


def run_test(hp, task, vocoder=None, global_step: int = 0) -> str:
    """Run the test split through ``task.sample`` and save artifacts;
    returns the generated directory."""
    test_ds = FastSpeechDataset("test", hp, shuffle=False)
    batches = batch_by_size(list(range(len(test_ds))), test_ds.num_tokens,
                            max_tokens=hp.get("max_eval_tokens", 60000)
                            or 60000, max_sentences=1)
    it = BatchIterator(test_ds, batches,
                       pad_multiple=int(hp.get("frames_multiple", 128)))
    work_dir = hp["work_dir"]
    gen_dir = os.path.join(
        work_dir, f"generated_{global_step}_{hp.get('gen_dir_name', '')}")
    for d in (f"{gen_dir}/wavs", f"{gen_dir}/plot",
              os.path.join(work_dir, "P_mels_npy"),
              os.path.join(work_dir, "G_mels_npy")):
        os.makedirs(d, exist_ok=True)
    sr = hp["audio_sample_rate"]
    futures = []
    with ThreadPoolExecutor(max_workers=min(os.cpu_count() or 4, 16)) as pool:
        for i, batch in enumerate(it):
            out = task.sample(batch, key=(i,))
            mel_pred, mask = _nonpadded(
                out["mel_out"][0].float().cpu().numpy(), hp)
            f0_pred = out["f0_denorm"][0].float().cpu().numpy()[
                : len(mask)][mask]
            item_name = batch["item_name"][0]
            if vocoder is not None:
                wav_pred = vocoder.spec2wav(mel_pred, f0=f0_pred)
                futures.append(pool.submit(
                    save_result, wav_pred, mel_pred, "P", item_name, gen_dir,
                    work_dir, sr))
                if hp.get("save_gt"):
                    mel_gt, gt_mask = _nonpadded(np.asarray(batch["mels"][0]),
                                                 hp)
                    f0_gt = np.asarray(denorm_f0(
                        batch["f0"][0], batch["uv"][0],
                        pitch_norm=hp.get("pitch_norm", "log"),
                        use_uv=hp.get("use_uv", False),
                        f0_mean=float(hp.get("f0_mean", 0.0) or 0.0),
                        f0_std=float(hp.get("f0_std", 1.0) or 1.0)))[
                            : len(gt_mask)][gt_mask]
                    wav_gt = vocoder.spec2wav(mel_gt, f0=f0_gt)
                    futures.append(pool.submit(
                        save_result, wav_gt, mel_gt, "G", item_name, gen_dir,
                        work_dir, sr))
            else:
                np.save(os.path.join(work_dir, "P_mels_npy",
                                     str(item_name).replace("/", "-")),
                        mel_pred)
            print(f"| test item {i}: {item_name} pred {mel_pred.shape}")
        for f in futures:
            f.result()
    print(f"| test artifacts under {gen_dir}")
    return gen_dir
