"""Consumer of the exported ONNX artifact chain, on the port's runtime.

Counterpart of ``tools/run_onnx_chain.py``: what community inference hosts
(MoeSS-style, reference onnx_export.py:12-17) do with
``{proj}_encoder/_denoise/_pred/_after.onnx``: run the encoder once,
iterate the PLMS loop exactly as the reference does over its exported graphs
(diffusion_V2.py:305-345) or the DPM-Solver++ step graph over its ladder,
decode the mel, and (when ``{proj}_hifigan.onnx`` / ``{proj}_istft.onnx``
is present) vocode to a waveform, using nothing but :mod:`.runtime` and
numpy (no model code).

    python -m diffsvc_tpu_torch.onnx.chain --artifacts exported/myproj \
        --project myproj --features feats.npz --acc 20 --K_step 1000

feats.npz keys:
    hubert [1, T_ph, H] f32    content units
    mel2ph [1, T] int           1-based alignment (0 = padding)
    f0     [1, T] f32           normalized log2-f0 (the encoder input)
    noise  [1, 1, M, T] f32     optional x_T (random from --seed if absent)

Writes ``mel.npy`` [1, M, T] (ln-mel, the _after output) and ``wav.npy``
when a vocoder artifact exists.
"""

import argparse
import json
import os

import numpy as np

from .runtime import OnnxRunner


def plms_chain(den, pred, x, cond, k_step: int, interval: int):
    """The reference's exported-graph PLMS loop (diffusion_V2.py:305-345):
    Adams-Bashforth order ramps 1->4 over a deque of past noise
    predictions; the order-1 bootstrap does a second denoise at t_prev."""
    noise_list = []
    for t in reversed(range(0, k_step, interval)):
        tt = np.asarray([t], np.int64)
        tp = np.asarray([max(t - interval, 0)], np.int64)
        noise_pred = den(x, tt, cond)[0]
        if len(noise_list) == 0:
            x_pred = pred(x, noise_pred, tt, tp)[0]
            noise_pred_prev = den(x_pred, tp, cond)[0]
            noise_prime = (noise_pred + noise_pred_prev) / 2.0
        elif len(noise_list) == 1:
            noise_prime = (3.0 * noise_pred - noise_list[-1]) / 2.0
        elif len(noise_list) == 2:
            noise_prime = (23.0 * noise_pred - 16.0 * noise_list[-1]
                           + 5.0 * noise_list[-2]) / 12.0
        else:
            noise_prime = (55.0 * noise_pred - 59.0 * noise_list[-1]
                           + 37.0 * noise_list[-2]
                           - 9.0 * noise_list[-3]) / 24.0
        x = pred(x, noise_prime, tt, tp)[0]
        noise_list.append(noise_pred)
        if len(noise_list) > 3:
            noise_list.pop(0)
    return x


def dpmpp_chain(den, dpmpp, meta, x, cond):
    """The fast-profile loop for ``{proj}_dpmpp.onnx``: every per-step
    coefficient is baked in the graph, the host just walks the exported
    ladder feeding the previous data prediction back in."""
    ts = meta["timesteps"]
    x0_prev = np.zeros_like(x)
    for i, t in enumerate(ts):
        eps = den(x, np.asarray([t], np.int64), cond)[0]
        x, x0_prev = dpmpp(x, eps, x0_prev, np.asarray([i], np.int64))
    return x


def run_chain(artifact_dir: str, project: str, feats: dict, *,
              k_step: int = 1000, acc: int = 20, seed: int = 0,
              n_mels: int = None, sampler: str = "plms"):
    """Returns (mel [1, M, T] ln-domain, f0_pred [1, T] Hz, wav or None)."""
    def load(stage):
        path = os.path.join(artifact_dir, f"{project}_{stage}.onnx")
        if not os.path.exists(path):
            return None
        return OnnxRunner(open(path, "rb").read())

    enc, den, pred, after = (load(s) for s in
                             ("encoder", "denoise", "pred", "after"))
    assert enc and den and pred and after, (
        f"missing artifacts under {artifact_dir} (need "
        f"{project}_encoder/_denoise/_pred/_after.onnx)")

    hub = np.asarray(feats["hubert"], np.float32)
    mel2ph = np.asarray(feats["mel2ph"], np.int64)
    f0 = np.asarray(feats["f0"], np.float32)
    spk = np.asarray(feats.get("spk_embed", np.zeros((1,), np.int64)),
                     np.int64)
    cond, f0_pred = enc(hub, mel2ph, spk, f0)
    t_mel = mel2ph.shape[1]
    if n_mels is None:
        # the denoise graph's noise input is [1, 1, M, T]
        m_info = [v for v in den.graph.input if v.name == "noise"][0]
        n_mels = int(m_info.type.tensor_type.shape.dim[2].dim_value)
    if "noise" in feats:
        x = np.asarray(feats["noise"], np.float32)
    else:
        x = np.random.RandomState(seed).randn(1, 1, n_mels,
                                              t_mel).astype(np.float32)

    if sampler == "dpmpp":
        dpmpp = load("dpmpp")
        meta_path = os.path.join(artifact_dir, f"{project}_dpmpp_meta.json")
        assert dpmpp is not None and os.path.exists(meta_path), (
            f"missing {project}_dpmpp.onnx/_dpmpp_meta.json under "
            f"{artifact_dir} (export with sampler: dpmpp)")
        with open(meta_path) as f:
            meta = json.load(f)
        x = dpmpp_chain(den, dpmpp, meta, x, cond)
    else:
        x = plms_chain(den, pred, x, cond, k_step, acc)
    mel = after(x)[0]          # [1, M, T] natural-log mel

    wav = None
    voc = load("hifigan")
    is_istft = False
    if voc is None:
        voc = load("istft")
        is_istft = voc is not None
    if voc is not None:
        rng = np.random.RandomState(seed + 1)
        names = voc.input_names
        if is_istft:
            # the iSTFT head consumes log10-mel [1, T, M]; _after emits
            # ln-mel [1, M, T]
            mel_in = (mel / np.log(10.0)).transpose(0, 2, 1)
        else:
            mel_in = mel
        args = {"mel": mel_in.astype(np.float32),
                "f0": np.asarray(f0_pred, np.float32)}
        if "rand_ini" in names:
            # NSF source randomness is declared as inputs (deterministic
            # artifact): H+1 from the rand_ini shape, L = T * total_up with
            # total_up recorded in the artifact's doc_string by the exporter
            vin = {v.name: v for v in voc.graph.input}
            h1 = int(vin["rand_ini"].type.tensor_type.shape.dim[1].dim_value)
            doc = voc.model.doc_string
            if "total_up=" not in doc:
                raise SystemExit("cannot infer noise length; artifact "
                                 "lacks total_up= in doc_string")
            L = t_mel * int(doc.split("total_up=")[1].split()[0])
            args["rand_ini"] = rng.rand(1, h1).astype(np.float32)
            args["noise"] = rng.randn(1, h1, L).astype(np.float32)
        wav = voc(*[args[n] for n in names])[0]
    return mel, f0_pred, wav


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--artifacts", required=True)
    ap.add_argument("--project", required=True)
    ap.add_argument("--features", required=True)
    ap.add_argument("--K_step", type=int, default=1000)
    ap.add_argument("--acc", type=int, default=20)
    ap.add_argument("--sampler", default="plms", choices=["plms", "dpmpp"])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default=".")
    args = ap.parse_args(argv)

    feats = dict(np.load(args.features))
    mel, f0_pred, wav = run_chain(args.artifacts, args.project, feats,
                                  k_step=args.K_step, acc=args.acc,
                                  seed=args.seed, sampler=args.sampler)
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "mel.npy"), mel)
    outs = {"mel": "mel.npy", "mel_shape": list(mel.shape)}
    if wav is not None:
        np.save(os.path.join(args.out, "wav.npy"), wav)
        outs["wav"] = "wav.npy"
        outs["wav_len"] = int(np.asarray(wav).reshape(-1).shape[0])
    print(json.dumps(outs))


if __name__ == "__main__":
    main()
