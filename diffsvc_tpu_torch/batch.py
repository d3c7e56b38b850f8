"""Folder batch conversion: converts every wav under ./batch and writes the
waveform plus ``{name}_mel.npy`` / ``{name}_f0.npy`` through the
``singer=True`` path (counterpart of the repository's ``batch.py``;
reference ``batch.py``).

    python -m diffsvc_tpu_torch.batch --project <name> --model <ckpt> \\
        --config <config.yaml> [--key 0] [--acc 50] [--device cpu]

The model runs on the card unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .infer.svc import Svc
from .utils.audio_io import format_wav, save_wav


def get_end_file(dir_path, end):
    file_lists = []
    for root, dirs, files in os.walk(dir_path):
        files = [f for f in files if f[0] != "."]
        dirs[:] = [d for d in dirs if d[0] != "."]
        for f_file in files:
            if f_file.endswith(end):
                file_lists.append(os.path.join(root, f_file).replace("\\", "/"))
    return file_lists


def run_clip(svc_model, key, acc, use_pe, use_crepe, thre, use_gt_mel,
             add_noise_step, f_name=None):
    wav_path = format_wav(f_name)
    _f0_tst, _f0_pred, _audio = svc_model.infer(
        wav_path, key=key, acc=acc, singer=True, use_pe=use_pe,
        use_crepe=use_crepe, thre=thre, use_gt_mel=use_gt_mel,
        add_noise_step=add_noise_step)
    out_path = f"./singer_data/{os.path.basename(f_name)}"
    save_wav(np.asarray(_audio), out_path, svc_model.hp["audio_sample_rate"])


def main(argv=None):
    ap = argparse.ArgumentParser(description="diffsvc_tpu_torch batch "
                                             "conversion")
    ap.add_argument("--project", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--key", type=int, nargs="+", default=[0])
    ap.add_argument("--acc", type=int, default=50)
    ap.add_argument("--thre", type=float, default=0.05)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the model runs (default: the card)")
    args = ap.parse_args(argv)

    model_path = args.model or f"./checkpoints/{args.project}/"
    config_path = args.config or f"./checkpoints/{args.project}/config.yaml"

    file_names = get_end_file("./batch", "wav")
    trans = list(args.key)
    if len(trans) < len(file_names):
        trans.extend([trans[0]] * (len(file_names) - len(trans)))
    os.makedirs("./batch", exist_ok=True)
    os.makedirs("./singer_data", exist_ok=True)

    model = Svc(args.project, config_path, True, model_path,
                device=args.device)
    for count, (f_name, tran) in enumerate(zip(file_names, trans), 1):
        print(f_name)
        run_clip(model, key=tran, acc=args.acc, use_crepe=False, thre=args.thre,
                 use_pe=False, use_gt_mel=False, add_noise_step=500,
                 f_name=f_name)
        print(f"process:{round(count * 100 / len(file_names), 2)}%")


if __name__ == "__main__":
    main()
