"""Svc — the end-to-end inference facade.

Counterpart of ``diffsvc_tpu/infer/svc.py`` (reference
``infer_tools/infer_tool.py:104-335``): ``Svc(project_name, config_name,
hubert_gpu, model_path)`` loads the diffusion model, HuBERT-soft and the
vocoder onto ``device`` (the card when there is one); ``infer(in_path, key,
acc, ...)`` runs feature extraction -> key shift (+key/12 in log2, ceiling
zeroing) -> sampling -> vocoder and returns (f0_gt, f0_pred, wav_pred).
The serving routes: ``infer_fused`` (the whole chain as one program per
length bucket, a CUDA graph on the card: ``infer/fused.py``),
``infer_fused_batched`` (N chunks in one such program) and
``infer_batched`` (the modular front end per clip, then one sampling and
one vocoder call per group of equal padded length).

f0: CREPE by default (``use_crepe=True``, as the JAX facade), on the card,
falling back to the AC tracker when CREPE's weights are missing; only real
CREPE tracks go into the md5 f0 cache.  pe (``models/pe.py``) is loaded
when ``pe_ckpt``'s directory exists and, with ``use_pe``, takes the
vocoder's f0 from the generated mel on the modular and batched routes.
The fused routes run the AC tracker and no pe whatever the flags say, as
the JAX package's do.
"""

from __future__ import annotations

import copy
import hashlib
import io
import json
import os
import time

import numpy as np
import torch

from ..config import set_hparams
from ..data import features
from ..models import pe as pe_model
from ..models.diffusion import GaussianDiffusion
from ..ops import mel as mel_ops
from ..ops.pitch import denorm_f0
from ..utils import convert
from ..vocoders import generator as gen_mod
from ..vocoders.base import get_vocoder_cls
from .hubert_encoder import Hubertencoder

F0_CACHE_PATH = "./infer_tools/f0_temp.json"


def read_temp(file_name: str) -> dict:
    """JSON disk cache with 50 MB / 14-day eviction (infer_tool.py:29-49)."""
    if not os.path.exists(file_name):
        os.makedirs(os.path.dirname(file_name) or ".", exist_ok=True)
        with open(file_name, "w") as f:
            f.write(json.dumps({"info": "temp_dict"}))
        return {}
    try:
        with open(file_name) as f:
            data_dict = json.loads(f.read())
        if os.path.getsize(file_name) > 50 * 1024 * 1024:
            print(f"clean {os.path.basename(file_name)}")
            for wav_hash in list(data_dict.keys()):
                item = data_dict[wav_hash]
                if isinstance(item, dict) and \
                        int(time.time()) - int(item.get("time", 0)) > 14 * 24 * 3600:
                    del data_dict[wav_hash]
    except (OSError, ValueError) as e:
        print(e, f"{file_name} error, auto rebuild file")
        data_dict = {"info": "temp_dict"}
    return data_dict


def write_temp(file_name: str, data: dict) -> None:
    with open(file_name, "w") as f:
        f.write(json.dumps(data))


def get_md5(content) -> str:
    return hashlib.new("md5", content).hexdigest()


def default_device(asked=None) -> torch.device:
    """The device an entry point runs on: the one the caller ``asked`` for
    (``device="cpu"``, ``--device cpu``), else the card.  Asking for the
    card, by name or by default, raises when there is none: the port never
    falls back to the CPU."""
    if asked is not None and torch.device(asked).type != "cuda":
        return torch.device(asked)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port runs on an NVIDIA GPU; "
                           "ask for the CPU with device='cpu' (--device cpu "
                           "on the command line)")
    return torch.device(asked if asked is not None else "cuda")


class Svc:
    def __init__(self, project_name: str, config_name: str, hubert_gpu: bool,
                 model_path: str, pad_multiple: int = 256, device=None):
        self.project_name = project_name
        self.model_path = model_path
        self.pad_multiple = pad_multiple
        self.device = default_device(device)
        self.hp = set_hparams(config=config_name, exp_name=project_name,
                              infer=True, reset=True, hparams_str="",
                              print_hparams=False)
        self.hp["hubert_gpu"] = hubert_gpu
        self.mel_bins = self.hp["audio_num_mel_bins"]
        self.model = GaussianDiffusion(self.hp)
        convert.load_reference_state(
            self.model, convert.load_ckpt_state_dict(model_path))
        self.model.to(self.device).eval()
        self.hubert = Hubertencoder(
            self.hp["hubert_path"], hp=self.hp,
            device=self.device if hubert_gpu else "cpu")
        # pe, as the JAX facade: loaded when its checkpoint directory
        # exists; a load that fails leaves the conditioner's f0
        self.pe = None
        pe_ckpt = self.hp.get("pe_ckpt", "")
        if pe_ckpt and os.path.exists(pe_ckpt.split("/model_ckpt")[0]):
            try:
                self.pe = pe_model.load(pe_ckpt, self.hp, self.device)
                print(f"| Loaded pe from {pe_ckpt}")
            except Exception as e:
                print(f"| pe load failed ({e}); use_pe will fall back to "
                      "fs2 f0")
        self.vocoder = get_vocoder_cls(self.hp)(self.hp, device=self.device)
        self.f0_dict = read_temp(F0_CACHE_PATH)
        self.spk_map = {}
        if self.hp.get("use_spk_id"):
            smp = os.path.join(str(self.hp.get("binary_data_dir", "")),
                               "spk_map.json")
            if os.path.exists(smp):
                with open(smp, encoding="utf-8") as f:
                    self.spk_map = json.load(f)
        self.timings = {}   # seconds per phase of the last infer()
        self._fused = None
        self._fused_key = None

    # ------------------------------------------------------------------
    def fused_model(self, acc: int = 20, compute_dtype=None):
        """The :class:`~.fused.FusedSvc` of this model at ``acc`` (built on
        first use; it snapshots ``hp`` then, so set serving flags such as
        ``fused_bucket_samples`` before)."""
        key = (int(acc), compute_dtype)
        if self._fused is None or self._fused_key != key:
            from .fused import FusedSvc

            hub = self.hubert.model
            if hub is not None and next(hub.parameters()).device \
                    != self.device:
                hub = copy.deepcopy(hub).to(self.device)
            self._fused = FusedSvc(self.hp, self.model, self.vocoder, hub,
                                   speedup=int(acc),
                                   compute_dtype=compute_dtype)
            self._fused_key = key
        return self._fused

    def infer_fused(self, wav, key: int = 0, acc: int = 20, seed: int = 0,
                    compute_dtype=None, use_gt_mel: bool = False,
                    add_noise_step: int = 500, init_noise=None,
                    voc_randoms=None, step_noise=None):
        """Serving fast path: one chunk (float32 or int16 at the model's
        rate) through the fused program; returns (wav, f0, mel) as host
        numpy.  The noise comes from ``seed`` unless ``init_noise`` /
        ``voc_randoms`` / ``step_noise`` (DDPM) are given."""
        fused = self.fused_model(acc, compute_dtype)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return fused(wav, gen, key_shift=key,
                     spk_id=self.resolve_spk_id(None), use_gt_mel=use_gt_mel,
                     add_noise_step=int(add_noise_step),
                     init_noise=init_noise, voc_randoms=voc_randoms,
                     step_noise=step_noise)

    def infer_fused_batched(self, wavs, key: int = 0, acc: int = 20,
                            seed: int = 0, compute_dtype=None,
                            init_noise=None, voc_randoms=None):
        """N chunks in one fused program at B = N (FusedSvc.batched);
        returns a list of (wav, f0, mel) per chunk."""
        fused = self.fused_model(acc, compute_dtype)
        gen = torch.Generator(device=self.device).manual_seed(int(seed))
        return fused.batched(list(wavs), gen, key_shifts=key,
                             spk_id=self.resolve_spk_id(None),
                             init_noise=init_noise, voc_randoms=voc_randoms)

    # ------------------------------------------------------------------
    def infer(self, in_path, key: int, acc: int, use_pe=True, use_crepe=True,
              thre=0.05, singer=False, seed=0, **kwargs):
        """Convert one clip.  ``init_noise`` ([1, T, M]), ``step_noise``
        (DDPM's per-step noise, [t_start, 1, T, M]) and ``voc_randoms``
        (generator.draw_randoms output) may be passed to fix the sampler's
        and the NSF source's noise; otherwise they come from ``seed``."""
        self.timings = {}
        batch = self.pre(in_path, acc, use_crepe, thre,
                         spk_id=kwargs.get("spk_id"))
        # key shift in log2 with ceiling zeroing (infer_tool.py:149-150)
        batch["f0"] = batch["f0"] + (key / 12)
        batch["f0"][batch["f0"] > np.log2(self.hp["f0_max"])] = 0

        dev = self.device
        tb = {k: torch.from_numpy(np.asarray(batch[k])).to(dev)
              for k in ("hubert", "mels", "mel2ph", "energy", "f0", "uv")}
        if self.hp.get("use_spk_id") and "spk_ids" in batch:
            tb["spk_embed"] = torch.from_numpy(batch["spk_ids"]).to(dev)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        noise = {k: None if kwargs.get(k) is None else torch.as_tensor(
            kwargs[k], dtype=torch.float32)
            for k in ("init_noise", "step_noise")}
        t0 = time.time()
        outputs = self.model.infer(
            tb, speedup=int(acc),
            use_gt_mel=bool(kwargs.get("use_gt_mel", False)),
            add_noise_step=int(kwargs.get("add_noise_step", 500)),
            generator=gen, **noise)
        mel_out = outputs["mel_out"].cpu().numpy()
        self.timings["diffusion"] = time.time() - t0
        print(f"executing 'diff_infer' costed {self.timings['diffusion']:.3f}s")

        batch["outputs"] = mel_out
        batch["f0_gt"] = denorm_f0(
            batch["f0"], batch["uv"], pitch_norm=self.hp.get("pitch_norm", "log"),
            use_uv=self.hp.get("use_uv", False),
            f0_mean=float(self.hp.get("f0_mean", 0.0) or 0.0),
            f0_std=float(self.hp.get("f0_std", 1.0) or 1.0))
        f0_pred = outputs["f0_denorm"]
        if use_pe and self.pe is not None:
            t0 = time.time()
            f0_pred = self.pe(outputs["mel_out"])["f0_denorm_pred"]
            self.timings["pe"] = time.time() - t0
        batch["f0_pred"] = f0_pred.cpu().numpy()
        return self.after_infer(batch, singer, in_path, seed=seed,
                                voc_randoms=kwargs.get("voc_randoms"))

    @torch.no_grad()
    def infer_batched(self, inputs, key: int, acc: int, use_pe=True,
                      use_crepe=True, thre=0.05, seed=0, init_noise=None,
                      voc_randoms=None):
        """Convert many clips or chunks: the front end per clip, then per
        group of equal padded (mel, unit) length one sampling call (K2 at
        B = the group's size) and one vocoder call (K3 at that B).  Returns
        (f0_gt, f0_pred, wav_pred) per input, in input order.

        ``init_noise`` (one [T, M] array per input, T its padded mel length)
        and ``voc_randoms`` (one (rand_ini [H+1], unit_noise [H+1, T*hop])
        pair per input) replace the draws from ``seed``.  With ``use_pe``
        and pe loaded, the vocoder's f0 is pe's on the group's mel."""
        hp, dev = self.hp, self.device
        is_nsf = "nsf" in str(hp.get("vocoder", "")).lower()
        samples = []
        for in_path in inputs:
            b1 = self.pre(in_path, acc, use_crepe, thre)
            b1["f0"] = b1["f0"] + (key / 12)
            b1["f0"][b1["f0"] > np.log2(hp["f0_max"])] = 0
            samples.append(b1)
        groups = {}
        for i, b1 in enumerate(samples):
            groups.setdefault((b1["mels"].shape[1], b1["hubert"].shape[1]),
                              []).append(i)
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        cfg = self.vocoder.cfg
        results = [None] * len(samples)
        for idxs in groups.values():
            stack = {k: np.concatenate([samples[i][k] for i in idxs])
                     for k in ("hubert", "mels", "mel2ph", "energy", "f0",
                               "uv")}
            tb = {k: torch.from_numpy(v).to(dev) for k, v in stack.items()}
            if hp.get("use_spk_id") and "spk_ids" in samples[idxs[0]]:
                tb["spk_embed"] = torch.from_numpy(np.concatenate(
                    [samples[i]["spk_ids"] for i in idxs])).to(dev)
            noise = None if init_noise is None else torch.from_numpy(
                np.stack([np.asarray(init_noise[i], np.float32)
                          for i in idxs]))
            out = self.model.infer(tb, speedup=int(acc), init_noise=noise,
                                   generator=gen)
            mel_out = out["mel_out"]
            f0_pred_all = out["f0_denorm"]
            if use_pe and self.pe is not None:
                f0_pred_all = self.pe(mel_out)["f0_denorm_pred"]
            # collate-padding frames are exact-0 mel: as log-mel that is
            # loud broadband energy that would bleed into the kept frames
            # through the generator's receptive field, so floor them to the
            # silence level before vocoding
            pad = (mel_out.abs().sum(-1) <= 0)[:, :, None]
            mel_clip = torch.clamp(mel_out, hp["mel_vmin"], hp["mel_vmax"])
            mel_clip = torch.where(pad, torch.full_like(mel_clip,
                                                        hp["mel_vmin"]),
                                   mel_clip)
            b, t_mel = mel_out.shape[:2]
            n_voc = t_mel * int(np.prod(cfg.upsample_rates))
            if voc_randoms is None:
                randoms = gen_mod.draw_randoms(b, n_voc, cfg.harmonic_num,
                                               gen, dev)
            else:
                randoms = tuple(torch.from_numpy(np.stack(
                    [np.asarray(voc_randoms[i][k], np.float32)
                     for i in idxs])).to(dev) for k in (0, 1))
            wavs = gen_mod.apply_serving(
                self.vocoder.gen, mel_clip * (mel_ops.LN_10 if is_nsf else 1.0),
                f0_pred_all if hp.get("use_nsf") else None, randoms)
            mel_out, wavs = mel_out.cpu().numpy(), wavs.cpu().numpy()
            f0_pred_all = f0_pred_all.cpu().numpy()
            f0_gt_all = denorm_f0(
                stack["f0"], stack["uv"], pitch_norm=hp.get("pitch_norm", "log"),
                use_uv=hp.get("use_uv", False),
                f0_mean=float(hp.get("f0_mean", 0.0) or 0.0),
                f0_std=float(hp.get("f0_std", 1.0) or 1.0))
            hop_up = wavs.shape[1] // t_mel
            for j, i in enumerate(idxs):
                # real frames are a prefix: the padding is trailing
                mask = np.abs(mel_out[j]).sum(-1) > 0
                results[i] = (f0_gt_all[j][mask], f0_pred_all[j][mask],
                              wavs[j][: int(mask.sum()) * hop_up])
        return results

    def after_infer(self, prediction, singer=False, in_path="", seed=0,
                    voc_randoms=None):
        """Unpad by the nonzero-mel mask, clip, vocode (infer_tool.py:171-201)."""
        mel_gt = prediction["mels"][0] if prediction["mels"].ndim == 3 \
            else prediction["mels"]
        mel_gt_mask = np.abs(mel_gt).sum(-1) > 0
        mel_pred = prediction["outputs"][0] if prediction["outputs"].ndim == 3 \
            else prediction["outputs"]
        mel_pred_mask = np.abs(mel_pred).sum(-1) > 0
        mel_pred = np.clip(mel_pred[mel_pred_mask], self.hp["mel_vmin"],
                           self.hp["mel_vmax"])
        f0_gt = prediction.get("f0_gt")
        if f0_gt is not None:
            f0_gt = (f0_gt[0] if f0_gt.ndim == 2 else f0_gt)[mel_gt_mask]
        f0_pred = prediction["f0_pred"]
        f0_pred = f0_pred[0] if f0_pred.ndim == 2 else f0_pred
        f0_pred = f0_pred[: len(mel_pred_mask)][mel_pred_mask]
        if singer:
            data_path = str(in_path).replace("batch", "singer_data")
            np.save(data_path[:-4] + "_mel.npy", mel_pred)
            np.save(data_path[:-4] + "_f0.npy", f0_pred)
        t0 = time.time()
        wav_pred = self.vocoder.spec2wav(mel_pred, f0=f0_pred, seed=seed,
                                         randoms=voc_randoms)
        self.timings["vocoder"] = time.time() - t0
        print(f"executing 'after_infer' costed {self.timings['vocoder']:.3f}s")
        return f0_gt, f0_pred, wav_pred

    # ------------------------------------------------------------------
    def _cached_pitch(self, wav, mel, use_crepe: bool, thre: float = 0.05):
        """The f0 of one clip; CREPE tracks are kept in the md5 f0 cache,
        and only real ones (``diffsvc_tpu/infer/svc.py:340-360``): an AC
        fallback is never stored under CREPE's key."""
        if not use_crepe:
            return features.get_pitch(wav, mel, self.hp, False, thre,
                                      device=self.device)
        md5 = get_md5(wav)
        if f"{md5}_gt" in self.f0_dict:
            print("load temp crepe f0")
            return (np.array(self.f0_dict[f"{md5}_gt"]["f0"]),
                    np.array(self.f0_dict[f"{md5}_coarse"]["f0"]))
        gt, coarse, tag = features.get_pitch(wav, mel, self.hp, True, thre,
                                             device=self.device,
                                             return_tag=True)
        if tag == "crepe":
            now = int(time.time())
            self.f0_dict[f"{md5}_gt"] = {"f0": gt.tolist(), "time": now}
            self.f0_dict[f"{md5}_coarse"] = {
                "f0": np.asarray(coarse).tolist(), "time": now}
            write_temp(F0_CACHE_PATH, self.f0_dict)
        return gt, coarse

    def temporary_dict2processed_input(self, item_name, temp_dict,
                                       use_crepe=True, thre=0.05):
        hp = self.hp
        t0 = time.time()
        wav, mel = features.wav2spec_for(hp, temp_dict["wav_fn"], self.device)
        self.timings["mel"] = time.time() - t0
        processed = {"item_name": item_name, "mel": mel,
                     "sec": len(wav) / hp["audio_sample_rate"],
                     "len": mel.shape[0], **temp_dict}
        ba = hp.get("binarization_args", {})
        if ba.get("with_f0", True):
            t0 = time.time()
            processed["f0"], processed["pitch"] = self._cached_pitch(
                wav, mel, use_crepe, thre)
            self.timings["f0"] = time.time() - t0
            print(f"executing 'get_pitch' costed {self.timings['f0']:.3f}s")
        if ba.get("with_hubert", True):
            t0 = time.time()
            processed["hubert"] = self.hubert.encode(temp_dict["wav_fn"])
            self.timings["hubert"] = time.time() - t0
            print(f"hubert time used {self.timings['hubert']:.3f}")
            if ba.get("with_align", True):
                processed["mel2ph"] = features.get_align_uniform(
                    mel.shape[0], processed["hubert"].shape[0])
        return processed

    def resolve_spk_id(self, spk_id=None) -> int:
        """Explicit int wins; else project_name / speaker_id through the
        binarizer's spk_map; else 0."""
        if spk_id is not None and not isinstance(spk_id, str):
            return int(spk_id)
        for name in (spk_id, self.project_name, self.hp.get("speaker_id")):
            if name is None:
                continue
            if isinstance(name, str) and name in self.spk_map:
                return int(self.spk_map[name])
            if not isinstance(name, str):
                return int(name)
        return 0

    def pre(self, wav_fn, accelerate, use_crepe=True, thre=0.05, spk_id=None):
        if isinstance(wav_fn, io.BytesIO):
            item_name = self.project_name
        else:
            item_name = os.path.splitext(os.path.basename(str(wav_fn)))[0]
        temp_dict = {"wav_fn": wav_fn, "spk_id": self.resolve_spk_id(spk_id)}
        processed = self.temporary_dict2processed_input(
            item_name, temp_dict, use_crepe, thre)
        self.hp["pndm_speedup"] = accelerate
        sample = features.getitem(processed, self.hp)
        return features.processed_input2batch(
            [sample], self.hp, pad_multiple=self.pad_multiple)
