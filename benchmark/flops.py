"""Peaks, and the operations and bytes of each unit of work, counted from
shapes.

The peaks and the denoiser's counts are copied from the port's
``diffsvc_tpu_torch/utils/devtime.py`` (``PEAK_FLOPS``, ``PEAK_BYTES``,
``eval_flops``, ``cond_flops``, ``stack_forward_flops``,
``train_model_flops``), so that a later change of the program cannot move
the yardstick; the counts of HuBERT-soft, the NSF-HiFiGAN / HiFi-GAN V1
convolutions and the kernels' bytes are the benchmark's own.  Every count
is of multiply-adds times two, of the products the algorithm needs (no
recompute, no padding unless the caller passes a padded shape).
"""

from __future__ import annotations

import math

# Published dense peaks of one H100 SXM (NVIDIA's data sheet): FLOP/s by
# operand type (f32 outside the tensor cores) and HBM bytes/s.  "tf32x3":
# f32 products as three TF32 passes on the tensor cores (495 / 3).
PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12, "tf32x3": 495e12 / 3}
PEAK_BYTES = 3.35e12
# the one peak every mfu share reads against: the highest rate of any
# operand type the port uses
MFU_PEAK = PEAK_FLOPS["bf16"]
# the tensor-core rate of a part by the precision its configuration states
RATE_OF = {"bf16": "bf16", "f32": "tf32x3"}
BYTES_OF = {"bf16": 2, "f32": 4}


def bound_s(flops: float, moved: float, precision: str) -> float:
    """The least time the card could take: the larger of the operations
    over the peak of the stated precision and the bytes over HBM's rate."""
    return max(flops / PEAK_FLOPS[RATE_OF[precision]], moved / PEAK_BYTES)


# ---------------------------------------------------------------- DiffNet

def eval_flops(t: int, c: int, layers: int, m: int) -> float:
    """One denoiser evaluation, 2T(MC + 8LC^2 + C^2 + CM): input
    projection, the stack (three dilated taps C x 2C and the output
    projection C x 2C per layer), skip and output projections."""
    return 2.0 * t * (m * c + layers * 8 * c * c + c * c + c * m)


def cond_flops(t: int, c: int, layers: int, h: int) -> float:
    """The conditioner's projection through every layer, once a clip:
    2T L H 2C."""
    return 2.0 * t * layers * h * 2 * c


def stack_forward_flops(b: int, t: int, c: int, layers: int) -> float:
    """The residual stack's forward: per layer and row 4 products of
    2 C 2C (three dilated taps and the output projection)."""
    return float(b) * layers * 4 * (2 * t * c * 2 * c)


def train_model_flops(b: int, t: int, c: int, layers: int) -> float:
    """Model FLOPs of a training step of the stack: 3x its forward."""
    return 3 * stack_forward_flops(b, t, c, layers)


def diffnet_train_flops(b: int, t: int, hp: dict) -> float:
    """Model FLOPs of a whole training step of the denoiser (3x the
    forward of the evaluation and of the conditioner's projection)."""
    c, n_l = int(hp["residual_channels"]), int(hp["residual_layers"])
    m, h = int(hp["audio_num_mel_bins"]), int(hp["hidden_size"])
    return 3.0 * b * (eval_flops(t, c, n_l, m) + cond_flops(t, c, n_l, h))


def sampler_evals(k_step: int, interval: int) -> int:
    """Denoiser evaluations of one PLMS trajectory: one per step and the
    first step's second one."""
    return max(-(-int(k_step) // int(interval)), 1) + 1


def ladder_bytes(t: int, c: int, layers: int, m: int, evals: int,
                 precision: str) -> float:
    """K2's inputs read once and output written once: x in and out (f32),
    the per-evaluation step biases [L, J, C] and the projected
    conditioner [L, T, 2C] in the stated precision, the weights in it."""
    e = BYTES_OF[precision]
    weights = (m * c + c + c * c + c + c * m + m
               + layers * (3 * c * 2 * c + 2 * c + c * 2 * c + 2 * c))
    return 2 * t * m * 4 + e * (layers * evals * c + layers * t * 2 * c
                                + weights)


# ----------------------------------------------------------------- HuBERT

HUBERT_CONVS = [(10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2)]


def hubert_flops(n16: int, cfg: dict) -> float:
    """HuBERT-soft's products for ``n16`` samples: the seven convolutions,
    the 512 -> dim projection, the grouped positional convolution, each
    encoder layer's in/out projections, attention scores and mix, and
    feed-forward, and the soft-unit projection."""
    dim, ffn = int(cfg["dim"]), int(cfg["ffn_dim"])
    n, f, c_in = n16 + 80, 0.0, 1
    for k, s in HUBERT_CONVS:
        n = (n - k) // s + 1
        f += 2.0 * c_in * 512 * k * n
        c_in = 512
    t = n
    f += 2.0 * t * 512 * dim
    f += 2.0 * t * dim * (dim // 16) * 128
    per_layer = (2.0 * t * dim * 3 * dim + 2 * 2.0 * t * t * dim
                 + 2.0 * t * dim * dim + 2 * 2.0 * t * dim * ffn)
    f += int(cfg["num_layers"]) * per_layer
    f += 2.0 * t * dim * int(cfg["proj_dim"])
    return f


# ---------------------------------------------------------------- vocoder

def _stage_ch(voc: dict, i: int) -> int:
    return int(voc["upsample_initial_channel"]) // (2 ** (i + 1))


def tail_start(voc: dict) -> int:
    """The first stage of at most 128 channels: where the port's K3 takes
    over from the plain prologue (the last stage if none)."""
    for i in range(len(voc["upsample_rates"])):
        if _stage_ch(voc, i) <= 128:
            return i
    return len(voc["upsample_rates"]) - 1


def vocoder_parts(voc: dict, t_mel: int, nsf: bool = True) -> dict:
    """Products of the generator on ``t_mel`` frames by part:
    'pre' (conv_pre), and per stage i 'up{i}' (its transposed conv),
    'noise{i}' (the NSF noise conv), 'res{i}' (its resblocks), then
    'post' (conv_post)."""
    c0, m = int(voc["upsample_initial_channel"]), int(voc["num_mels"])
    out = {"pre": 2.0 * t_mel * m * c0 * 7}
    t, ch = t_mel, c0
    rates = [int(r) for r in voc["upsample_rates"]]
    for i, (u, k) in enumerate(zip(rates, voc["upsample_kernel_sizes"])):
        c = _stage_ch(voc, i)
        out[f"up{i}"] = 2.0 * t * ch * c * int(k)
        t *= u
        if nsf:
            kn = 2 * math.prod(rates[i + 1:]) if i + 1 < len(rates) else 1
            out[f"noise{i}"] = 2.0 * t * c * kn
        res = 0.0
        for k_rb, d_rb in zip(voc["resblock_kernel_sizes"],
                              voc["resblock_dilation_sizes"]):
            per = 2 if str(voc.get("resblock", "1")) == "1" else 1
            res += per * len(d_rb) * 2.0 * t * c * c * int(k_rb)
        out[f"res{i}"] = res
        ch = c
    out["post"] = 2.0 * t * ch * 7
    return out


def vocoder_flops(voc: dict, t_mel: int, nsf: bool = True) -> float:
    return sum(vocoder_parts(voc, t_mel, nsf).values())


def tail_flops(voc: dict, t_mel: int) -> float:
    """K3's products: the resblocks of stage s0 on, the transposed convs
    after s0, conv_post."""
    p, s0 = vocoder_parts(voc, t_mel), tail_start(voc)
    n = len(voc["upsample_rates"])
    return (sum(p[f"res{i}"] for i in range(s0, n))
            + sum(p[f"up{i}"] for i in range(s0 + 1, n)) + p["post"])


def tail_bytes(voc: dict, t_mel: int) -> float:
    """K3's inputs read once and output written once, f32: stage s0's
    activations, the NSF injections of the later stages, the weights,
    the output wave."""
    s0, n = tail_start(voc), len(voc["upsample_rates"])
    rates = [int(r) for r in voc["upsample_rates"]]
    t = t_mel * math.prod(rates[: s0 + 1])
    moved = t * _stage_ch(voc, s0)
    ch = _stage_ch(voc, s0)
    weights = 0
    for i in range(s0, n):
        c = _stage_ch(voc, i)
        if i > s0:
            t *= rates[i]
            moved += t * c
            weights += ch * c * int(voc["upsample_kernel_sizes"][i]) + c
        per = 2 if str(voc.get("resblock", "1")) == "1" else 1
        for k_rb, d_rb in zip(voc["resblock_kernel_sizes"],
                              voc["resblock_dilation_sizes"]):
            weights += per * len(d_rb) * (c * c * int(k_rb) + c)
        ch = c
    weights += ch * 7 + 1
    return 4.0 * (moved + weights + t)


# --------------------------------------------------------------------- pe

def pe_flops(hp: dict, t: int, conv_layers: int = 2) -> float:
    """diff-svc's pitch extractor on t frames: three k=5 prenet convs, the
    prenet's and encoder's projections, the encoder's k=5 convs, five k
    predictor convs and the 2-wide head."""
    h, m = int(hp["hidden_size"]), int(hp["audio_num_mel_bins"])
    ph = int(hp.get("predictor_hidden", -1))
    ph = ph if ph > 0 else h
    k = int(hp.get("predictor_kernel", 5))
    f = 2.0 * t * 5 * (m * h + 2 * h * h)
    f += 3 * 2.0 * t * h * h + conv_layers * 2.0 * t * h * h * 5
    f += 2.0 * t * k * (h * ph + 4 * ph * ph) + 2.0 * t * ph * 2
    return f


# --------------------------------------------------------- the conversion

def conversion_flops(config: dict, n_samples: int, acc: int) -> float:
    """Model FLOPs of converting ``n_samples`` of audio at the model's rate,
    unpadded: HuBERT on its 16 kHz resample, the conditioner's
    projection, every denoiser evaluation, the vocoder, and pe where the
    configuration has one."""
    hp, voc = config["hparams"], config["vocoder"]
    hop = int(hp["hop_size"])
    t_mel = -(-n_samples // hop)
    n16 = -(-n_samples * 16000 // int(hp["audio_sample_rate"]))
    c, n_l = int(hp["residual_channels"]), int(hp["residual_layers"])
    m, h = int(hp["audio_num_mel_bins"]), int(hp["hidden_size"])
    evals = sampler_evals(int(hp["K_step"]), acc)
    total = (hubert_flops(n16, config["hubert"])
             + cond_flops(t_mel, c, n_l, h)
             + evals * eval_flops(t_mel, c, n_l, m)
             + vocoder_flops(voc, t_mel, bool(hp.get("use_nsf", True))))
    if "pe" in config:
        total += pe_flops(hp, t_mel, int(config["pe"]["conv_layers"]))
    return total
