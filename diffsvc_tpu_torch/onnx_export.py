"""Deployment export CLI: the reference's split ONNX graphs from a project
checkpoint (counterpart of the repository's ``onnx_export.py``, reference
``onnx_export.py`` + ``modules/diff/diffusion_V2.py:252-352``).

    python -m diffsvc_tpu_torch.onnx_export --project myproj [--vocoder]

writes ``{proj}_encoder.onnx``, ``_denoise``, ``_pred`` and ``_after``
under ``--out`` (default ``./exported/{proj}``), plus ``{proj}_dpmpp.onnx``
and ``{proj}_dpmpp_meta.json`` when the config's ``sampler`` is dpmpp, and
with ``--vocoder`` ``{proj}_hifigan.onnx`` (or ``{proj}_istft.onnx`` for
the iSTFT head) from ``vocoder_ckpt``.  ``python -m
diffsvc_tpu_torch.onnx.chain`` drives the written graphs.

The export traces on the CPU by design, card or no card: the graphs hold
the function of each kernel, which the kernels' plain versions compute (a
CUDA kernel cannot be traced), and the exporter asks for those routes
explicitly.  ``--format stablehlo`` is refused: StableHLO is XLA's format,
and that export stays with the JAX package (``onnx_export.py``).
"""

from __future__ import annotations

import argparse


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--project", required=True)
    ap.add_argument("--model", default=None)
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--format", choices=("onnx", "stablehlo"), default="onnx",
                    help="onnx (traced on the CPU by design; the graphs "
                         "hold the kernels' plain versions)")
    ap.add_argument("--vocoder", action="store_true",
                    help="also export {proj}_hifigan.onnx (or _istft.onnx) "
                         "from hp['vocoder_ckpt']")
    ap.add_argument("--t_mel", type=int, default=1024,
                    help="the iSTFT head's fixed length (its graph has no "
                         "dynamic axis)")
    ap.add_argument("--t_ph", type=int, default=512,
                    help="accepted for onnx_export.py's flags; unused")
    ap.add_argument("--acc", type=int, default=10,
                    help="the dpmpp ladder's speedup when the config has no "
                         "pndm_speedup")
    args = ap.parse_args(argv)
    if args.format == "stablehlo":
        ap.error("--format stablehlo is XLA's format; the PyTorch port "
                 "exports ONNX only (use the JAX package's onnx_export.py "
                 "for StableHLO)")

    from .config.hparams import set_hparams
    from .onnx import svc_export as se

    model_path = args.model or f"./checkpoints/{args.project}/"
    config_path = args.config or f"./checkpoints/{args.project}/config.yaml"
    out_dir = args.out or f"./exported/{args.project}"
    hp = set_hparams(config=config_path, exp_name=args.project, infer=True,
                     reset=True, print_hparams=False)
    model = se.load_model(model_path, hp)
    paths = se.export_svc_onnx(hp, model, out_dir, args.project)
    if se.sampler_is_dpmpp(hp):
        paths.update(se.export_dpmpp_onnx(
            hp, out_dir, args.project,
            speedup=int(hp.get("pndm_speedup", args.acc))))
    if args.vocoder:
        if "istft" in str(hp.get("vocoder", "")).lower():
            from .vocoders import istft_head as ih

            head = ih.load_params(str(hp["vocoder_ckpt"]),
                                  ih.IstftVocoderConfig.from_hparams(hp))
            paths["istft"] = se.export_istft_onnx(head, out_dir, args.project,
                                                  t_mel=args.t_mel)
        else:
            from .vocoders.nsf_hifigan import load_model

            gen, _, _ = load_model(str(hp["vocoder_ckpt"]))
            paths["hifigan"] = se.export_vocoder_onnx(gen, out_dir,
                                                      args.project)
    for k, v in paths.items():
        print(f"| exported {k}: {v}")
    return paths


if __name__ == "__main__":
    main()
