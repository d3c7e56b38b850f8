"""GAN vocoder training: HiFi-GAN / NSF-HiFiGAN, the iSTFT head and PWG.

Counterpart of ``diffsvc_tpu/training/vocoder_task.py:31-336``
(``_factor_scales``, ``VocoderTask``, ``crop_batch``, ``train_vocoder``).
One step updates the discriminator on the generator's output (no gradient
to the generator), then the generator against the *updated*
discriminator; both forwards of a step share its draws (the NSF source's,
or PWG's noise z), as JAX's ``fold_in(rng, step)`` does.

    hifigan / istft: G = LSGAN adv + 2 * feature matching + 45 * mel-L1
                     (+ the multi-resolution STFT loss with
                     ``use_stft_loss``); D = LSGAN on MPD + MSD
    pwg:             G = multi-resolution STFT + 4 * LSGAN adv (mel-L1 a
                     metric); D = LSGAN on the PWG discriminator (or the
                     residual one, ``pwg_discriminator: residual``)

The mel of the loss is the NSF mel for the ``nsf`` and ``istft`` families
and the pwg mel otherwise; the NSF generator's input is ln-mel (log10-mel
times ln 10).  Both optimizers are optax's ``adamw(exponential_decay(lr,
1000, 0.999), b1=0.8, b2=0.99)``: eps 1e-8, weight decay 1e-4 (optax's
default; torch's is 1e-2), the rate ``lr * 0.999 ** (n / 1000)`` after n
updates of that optimizer.  The step's convolutions run in true f32
(``models.nn.true_f32_convs``), as the JAX package's f32 step does, and
no kernel of the port: the generators run their plain forwards.

Draws come from a ``torch.Generator`` seeded from (seed, step) on the
task's device, or are passed in (``draws``).  ``train_vocoder`` crops with
JAX's numpy ``RandomState`` draws and keeps its state in the checkpoint,
so a resumed run takes the crops the uninterrupted one would have (JAX
reseeds at ``seed + step`` on resume).
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config.hparams import HParams
from ..models.nn import true_f32_convs
from ..ops import mel as mel_ops
from ..ops.stft_loss import multi_resolution_stft_loss
from ..vocoders import discriminators as D
from ..vocoders import generator as gen_mod

B1, B2, EPS, WEIGHT_DECAY = 0.8, 0.99, 1e-8, 1e-4
DECAY_RATE, DECAY_STEPS = 0.999, 1000


def _factor_scales(hop: int):
    """Greedy 4/2 factorization of hop_size into PWG upsample scales
    (128 -> (4, 4, 4, 2), 256 -> (4, 4, 4, 4), 512 -> (4, 4, 4, 4, 2))."""
    scales = []
    while hop > 1:
        for f in (4, 2, 3, 5, 7):
            if hop % f == 0:
                scales.append(f)
                hop //= f
                break
        else:
            scales.append(hop)
            hop = 1
    return tuple(scales)


def family_of(hp) -> str:
    """``pwg`` (``vocoder_family: pwg``, or a vocoder name with pwg),
    ``istft`` or ``hifigan``."""
    voc = str(hp.get("vocoder", "")).lower()
    fam = str(hp.get("vocoder_family", "")).lower()
    if fam == "pwg" or (not fam and "pwg" in voc):
        return "pwg"
    return "istft" if "istft" in voc else "hifigan"


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The draws' generator of step ``step``: a function of (seed, step)
    alone, so a resumed run draws what the uninterrupted one did."""
    return torch.Generator(device=device).manual_seed(
        int(seed) * 1_000_003 + int(step))


class VocoderTask:
    def __init__(self, hp: HParams, device=None):
        from ..infer.svc import default_device

        self.hp = hp
        self.device = default_device(device)
        self.family = family_of(hp)
        self.seed = int(hp.get("seed", 1234))
        self.cfg = gen_mod.HifiGanConfig(
            num_mels=hp["audio_num_mel_bins"],
            upsample_initial_channel=int(hp.get("upsample_initial_channel",
                                                512)),
            upsample_rates=tuple(hp.get("upsample_rates", (8, 8, 2, 2, 2))),
            upsample_kernel_sizes=tuple(hp.get("upsample_kernel_sizes",
                                               (16, 16, 4, 4, 4))),
            resblock=str(hp.get("resblock", "1")),
            resblock_kernel_sizes=tuple(hp.get("resblock_kernel_sizes",
                                               (3, 7, 11))),
            resblock_dilation_sizes=tuple(tuple(d) for d in hp.get(
                "resblock_dilation_sizes", ((1, 3, 5),) * 3)),
            sampling_rate=hp["audio_sample_rate"],
            use_nsf=bool(hp.get("use_nsf", True)))
        # torch's default init, drawn from the seed without touching the
        # caller's global generator
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(self.seed)
            self.gen, self.disc = self._build()
        self.gen.to(self.device)
        self.disc.to(self.device)
        self.lr = float(hp.get("vocoder_lr", 2e-4))
        self.opt_g, self.opt_d = (
            torch.optim.AdamW(m.parameters(), lr=self.lr, betas=(B1, B2),
                              eps=EPS, weight_decay=WEIGHT_DECAY)
            for m in (self.gen, self.disc))
        self.lambda_mel = float(hp.get("lambda_mel", 45.0))
        self.lambda_fm = 1.0
        self.use_stft_loss = bool(hp.get("use_stft_loss", False))
        self.step = 0

    def _build(self):
        hp = self.hp
        if self.family == "istft":
            from ..vocoders import istft_head

            self.icfg = istft_head.IstftVocoderConfig.from_hparams(hp)
            gen = istft_head.IstftHead(self.icfg)
        elif self.family == "pwg":
            from ..vocoders import pwg

            hop = int(hp["hop_size"])
            scales = tuple(hp.get("pwg_upsample_scales")
                           or _factor_scales(hop))
            if int(np.prod(scales)) != hop:
                raise ValueError(f"pwg_upsample_scales {scales} must "
                                 f"multiply to hop {hop}")
            self.pcfg = pwg.PWGConfig(
                aux_channels=hp["audio_num_mel_bins"],
                upsample_scales=scales,
                layers=int(hp.get("pwg_layers", 30)),
                stacks=int(hp.get("pwg_stacks", 3)),
                residual_channels=int(hp.get("pwg_residual_channels", 64)),
                gate_channels=int(hp.get("pwg_gate_channels", 128)),
                skip_channels=int(hp.get("pwg_skip_channels", 64)))
            gen = pwg.ParallelWaveGANGenerator(self.pcfg)
            if str(hp.get("pwg_discriminator", "")).lower() == "residual":
                disc = pwg.ResidualParallelWaveGANDiscriminator(
                    pwg.ResidualPWGDiscriminatorConfig(
                        layers=int(hp.get("pwg_disc_layers", 30)),
                        stacks=int(hp.get("pwg_disc_stacks", 3))))
            else:
                disc = pwg.ParallelWaveGANDiscriminator(
                    pwg.PWGDiscriminatorConfig(
                        layers=int(hp.get("pwg_disc_layers", 10)),
                        conv_channels=int(hp.get("pwg_disc_channels", 64))))
            return gen, nn.ModuleDict({"pwg": disc})
        else:
            gen = gen_mod.Generator(self.cfg)
        return gen, nn.ModuleDict({"mpd": D.MultiPeriodDiscriminator(),
                                   "msd": D.MultiScaleDiscriminator()})

    # ------------------------------------------------------------------
    def mel_for_loss(self, wav: torch.Tensor) -> torch.Tensor:
        """[B, n] -> [B, T, M]: the NSF mel for the nsf and istft families
        (the geometry they are served with), else the pwg mel."""
        hp = self.hp
        voc = str(hp.get("vocoder", "nsf")).lower()
        fn = mel_ops.wav2mel_nsf if ("nsf" in voc or "istft" in voc) \
            else mel_ops.wav2mel_pwg
        return fn(wav, sr=hp["audio_sample_rate"], n_fft=hp["fft_size"],
                  hop=hp["hop_size"], win_length=hp["win_size"],
                  n_mels=hp["audio_num_mel_bins"], fmin=float(hp["fmin"]),
                  fmax=float(hp["fmax"]))

    def draw(self, batch: Dict, generator: torch.Generator):
        """The step's draws for a batch of [B, S] frames: PWG's noise z
        [B, S * hop], the NSF source's (``generator.draw_randoms``), or
        None."""
        b, s = batch["mels"].shape[:2]
        if self.family == "pwg":
            hop = int(np.prod(self.pcfg.upsample_scales))
            return torch.randn((b, s * hop), generator=generator,
                               device=self.device)
        if self.family == "hifigan" and self.cfg.use_nsf:
            return gen_mod.draw_randoms(
                b, s * int(np.prod(self.cfg.upsample_rates)),
                self.cfg.harmonic_num, generator, self.device)
        return None

    def gen_forward(self, batch: Dict, draws) -> torch.Tensor:
        if self.family == "istft":
            from ..vocoders import istft_head

            return istft_head.apply(self.gen, batch["mels"], batch["f0"])
        if self.family == "pwg":
            acw = self.pcfg.aux_context_window
            mel = F.pad(batch["mels"].transpose(1, 2), (acw, acw),
                        mode="replicate").transpose(1, 2)
            return self.gen(draws, mel)
        if self.cfg.use_nsf:
            return gen_mod.apply(self.gen, batch["mels"] * mel_ops.LN_10,
                                 batch["f0"], draws)
        return gen_mod.apply(self.gen, batch["mels"])

    def d_loss(self, y, y_hat):
        if self.family == "pwg":
            d = self.disc["pwg"]
            return D.discriminator_loss([d(y)], [d(y_hat)])
        rs, gs, _, _ = self.disc["mpd"](y, y_hat)
        rs2, gs2, _, _ = self.disc["msd"](y, y_hat)
        return D.discriminator_loss(rs, gs) + D.discriminator_loss(rs2, gs2)

    def g_loss(self, batch: Dict, draws):
        """(loss, metrics) of the generator against the current D."""
        y = batch["wav"]
        y_hat = self.gen_forward(batch, draws)
        mel_l1 = torch.abs(self.mel_for_loss(y_hat)
                           - self.mel_for_loss(y)).mean()
        if self.family == "pwg":
            adv = D.generator_loss([self.disc["pwg"](y_hat)])
            sc, mag = multi_resolution_stft_loss(y_hat.reshape(-1),
                                                 y.reshape(-1))
            return sc + mag + 4.0 * adv, {"g_adv": adv, "g_mel": mel_l1,
                                          "g_stft": sc + mag}
        _, gs, fr, fg = self.disc["mpd"](y, y_hat)
        _, gs2, fr2, fg2 = self.disc["msd"](y, y_hat)
        adv = D.generator_loss(gs) + D.generator_loss(gs2)
        fm = D.feature_loss(fr, fg) + D.feature_loss(fr2, fg2)
        loss = adv + self.lambda_fm * fm + self.lambda_mel * mel_l1
        extras = {"g_adv": adv, "g_fm": fm, "g_mel": mel_l1}
        if self.use_stft_loss:
            sc, mag = multi_resolution_stft_loss(y_hat.reshape(-1),
                                                 y.reshape(-1))
            loss = loss + sc + mag
            extras["g_stft"] = sc + mag
        return loss, extras

    def _update(self, opt, module: nn.Module, loss) -> None:
        """The grads of ``loss`` into ``.grad`` (kept after the step), then
        one AdamW update at the rate of this optimizer's update count."""
        params = list(module.parameters())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for p, g in zip(params, grads):
            p.grad = torch.zeros_like(p) if g is None else g
        state = opt.state.get(params[0], {})
        n = float(state["step"]) if "step" in state else 0.0
        for group in opt.param_groups:
            group["lr"] = self.lr * DECAY_RATE ** (n / DECAY_STEPS)
        opt.step()

    def batch_on_device(self, batch: Dict) -> Dict:
        return {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32,
                                   device=self.device)
                for k in ("mels", "wav", "f0")}

    def train_step(self, batch: Dict, draws=None) -> Dict:
        """One D update, then one G update against the updated D.  ``batch``
        is :func:`crop_batch`'s (numpy or tensors); ``draws`` replace the
        draws from :func:`step_generator` of this step.  Returns the step's
        losses (device scalars); each parameter's ``.grad`` holds its grad
        of this step."""
        b = self.batch_on_device(batch)
        if draws is None:
            draws = self.draw(b, step_generator(self.seed, self.step,
                                                self.device))
        with true_f32_convs():
            with torch.no_grad():
                y_hat = self.gen_forward(b, draws)
            d_loss = self.d_loss(b["wav"], y_hat)
            self._update(self.opt_d, self.disc, d_loss)
            g_loss, extras = self.g_loss(b, draws)
            self._update(self.opt_g, self.gen, g_loss)
        self.step += 1
        return {"d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
                **{k: v.detach() for k, v in extras.items()}}

    # ------------------------------------------------------------------
    def state_dict(self) -> Dict:
        """The generator under ``model_gen.`` (the reference trainer's keys:
        a PWG ``model_ckpt_steps_*.ckpt`` loads as a vocoder), the
        discriminator under ``model_disc.``, both optimizers."""
        sd = {f"model_gen.{k}": v for k, v in self.gen.state_dict().items()}
        sd.update({f"model_disc.{k}": v
                   for k, v in self.disc.state_dict().items()})
        return {"state_dict": sd, "vocoder_step": self.step,
                "optimizer_states": [self.opt_g.state_dict(),
                                     self.opt_d.state_dict()]}

    def load_state_dict(self, ckpt: Dict) -> None:
        from ..utils.convert import strip_prefix

        sd = ckpt["state_dict"]
        self.gen.load_state_dict(strip_prefix(sd, "model_gen."))
        self.disc.load_state_dict(strip_prefix(sd, "model_disc."))
        self.opt_g.load_state_dict(ckpt["optimizer_states"][0])
        self.opt_d.load_state_dict(ckpt["optimizer_states"][1])
        self.step = int(ckpt["vocoder_step"])


def crop_batch(items, hp, rng: np.random.RandomState,
               segment_frames: int = 32) -> Dict:
    """Random fixed-size crops, JAX's draws: mel [B, S, M], wav
    [B, S * hop], f0 [B, S] (numpy)."""
    hop = hp["hop_size"]
    mels, wavs, f0s = [], [], []
    for item in items:
        mel = np.asarray(item["mel"], np.float32)
        wav = np.asarray(item["wav"], np.float32)
        f0 = np.asarray(item["f0"], np.float32)
        s = rng.randint(0, max(mel.shape[0] - segment_frames, 0) + 1)
        m = mel[s: s + segment_frames]
        if m.shape[0] < segment_frames:
            m = np.pad(m, ((0, segment_frames - m.shape[0]), (0, 0)))
        w = wav[s * hop: (s + segment_frames) * hop]
        if len(w) < segment_frames * hop:
            w = np.pad(w, (0, segment_frames * hop - len(w)))
        f = f0[s: s + segment_frames]
        if len(f) < segment_frames:
            f = np.pad(f, (0, segment_frames - len(f)))
        mels.append(m)
        wavs.append(w)
        f0s.append(f)
    return {"mels": np.stack(mels), "wav": np.stack(wavs),
            "f0": np.stack(f0s)}


def train_vocoder(hp: HParams, device=None) -> VocoderTask:
    """``run``'s vocoder route: train on the binarized ``train`` split's
    items, which must keep their waveforms
    (``binarization_args.with_wav: true``), for ``max_updates`` steps of
    ``max_sentences`` crops of ``vocoder_segment_frames``; a checkpoint
    every ``val_check_interval`` steps and at the end, rotating in
    ``work_dir`` (``num_ckpt_keep``); resumes from the latest one there.
    ``task.history`` keeps each logged step's losses and its seconds."""
    from ..data.dataset import FastSpeechDataset
    from . import checkpoint as ckpt_lib

    ds = FastSpeechDataset("train", hp, shuffle=False)
    items = [ds._get_item(i) for i in range(len(ds))]
    if not items or any("wav" not in it for it in items):
        raise ValueError("vocoder training needs waveforms: binarize with "
                         "binarization_args.with_wav: true")
    task = VocoderTask(hp, device=device)
    seed = task.seed
    restored = ckpt_lib.restore_checkpoint(hp["work_dir"])
    step = 0
    rng_np = np.random.RandomState(seed)
    if restored is not None:
        ckpt, _, step, _ = restored
        task.load_state_dict(ckpt)
        if "crop_rng" in ckpt:
            rng_np.set_state(ckpt["crop_rng"])
        else:
            rng_np = np.random.RandomState(seed + step)
        print(f"| resumed vocoder training at step {step}")
    batch_size = int(hp.get("max_sentences", 8) or 8)
    seg = int(hp.get("vocoder_segment_frames", 32))
    max_updates = int(hp.get("max_updates", 100000))
    log_interval = int(hp.get("log_interval", 100))
    ckpt_interval = int(hp.get("val_check_interval", 2000))
    task.history = []
    t_log = time.perf_counter()
    while step < max_updates:
        picks = [items[rng_np.randint(len(items))] for _ in range(batch_size)]
        batch = crop_batch(picks, hp, rng_np, segment_frames=seg)
        metrics = task.train_step(batch)
        step += 1
        if step % log_interval == 0:
            m = {k: float(v) for k, v in metrics.items()}
            now = time.perf_counter()
            task.history.append(dict(m, step=step, seconds_per_step=(
                now - t_log) / log_interval))
            t_log = now
            print(f"| voc step {step} { {k: round(v, 4) for k, v in m.items()} }")
        if step % ckpt_interval == 0 or step >= max_updates:
            ckpt_lib.save_checkpoint(
                hp["work_dir"], dict(task.state_dict(),
                                     crop_rng=rng_np.get_state()),
                0, step, num_ckpt_keep=int(hp.get("num_ckpt_keep", 10)))
            t_log = time.perf_counter()
    print("| VOCODER TRAINING FINISHED")
    return task
