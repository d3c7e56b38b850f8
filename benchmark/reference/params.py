"""Parameter names and shapes of the three networks, in the reference
checkpoints' layouts (diff-svc's ``model.*`` trainer checkpoint, bshall's
``hubert_soft.pt``, openvpi's NSF-HiFiGAN ``generator``), worked out from a
configuration file of ``benchmark/configs``.

Each entry is (name, shape, kind, fan): ``kind`` says how
``benchmark/weights.py`` draws it ("uniform" +-1/sqrt(fan), "xavier" for
the attention's packed in-projection, "norm_w" / "norm_b" for normalization
affines, "embed" for an embedding table whose row 0 is the padding row).
"""

from __future__ import annotations


def _linear(out, name, n_in, n_out, bias=True):
    out.append((f"{name}.weight", (n_out, n_in), "uniform", n_in))
    if bias:
        out.append((f"{name}.bias", (n_out,), "uniform", n_in))


def _conv(out, name, c_in, c_out, k, groups=1, bias=True):
    fan = c_in // groups * k
    out.append((f"{name}.weight", (c_out, c_in // groups, k), "uniform", fan))
    if bias:
        out.append((f"{name}.bias", (c_out,), "uniform", fan))


def _convt(out, name, c_in, c_out, k):
    # torch's fan-in of a transposed conv weight [in, out, k] is out * k
    out.append((f"{name}.weight", (c_in, c_out, k), "uniform", c_out * k))
    out.append((f"{name}.bias", (c_out,), "uniform", c_out * k))


def _norm(out, name, n):
    out.append((f"{name}.weight", (n,), "norm_w", n))
    out.append((f"{name}.bias", (n,), "norm_b", n))


def diffusion(hp) -> list:
    """GaussianDiffusion with ``no_fs2``: the conditioner's pitch table and
    (unused) mel head, and DiffNet (reference ``network/diff/net.py``)."""
    h, m = int(hp["hidden_size"]), int(hp["audio_num_mel_bins"])
    c, n_layers = int(hp["residual_channels"]), int(hp["residual_layers"])
    out = []
    _linear(out, "fs2.mel_out", h, m)
    out.append(("fs2.pitch_embed.weight", (300, h), "embed", h))
    d = "denoise_fn"
    _conv(out, f"{d}.input_projection", m, c, 1)
    _linear(out, f"{d}.mlp.0", c, 4 * c)
    _linear(out, f"{d}.mlp.2", 4 * c, c)
    for i in range(n_layers):
        r = f"{d}.residual_layers.{i}"
        _conv(out, f"{r}.dilated_conv", c, 2 * c, 3)
        _linear(out, f"{r}.diffusion_projection", c, c)
        _conv(out, f"{r}.conditioner_projection", h, 2 * c, 1)
        _conv(out, f"{r}.output_projection", c, 2 * c, 1)
    _conv(out, f"{d}.skip_projection", c, c, 1)
    _conv(out, f"{d}.output_projection", c, m, 1)
    return out


HUBERT_CONVS = [(10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2)]


def hubert(cfg: dict) -> list:
    """HuBERT-soft (bshall/hubert ``hubert_soft.pt``, positional conv's
    weight norm folded)."""
    dim, ffn = int(cfg["dim"]), int(cfg["ffn_dim"])
    out = []
    _conv(out, "feature_extractor.conv0", 1, 512, 10, bias=False)
    _norm(out, "feature_extractor.norm0", 512)
    for i in range(1, 7):
        _conv(out, f"feature_extractor.conv{i}", 512, 512, HUBERT_CONVS[i][0],
              bias=False)
    _norm(out, "feature_projection.norm", 512)
    _linear(out, "feature_projection.projection", 512, dim)
    _conv(out, "positional_embedding.conv", dim, dim, 128, groups=16)
    _norm(out, "norm", dim)
    for i in range(int(cfg["num_layers"])):
        e = f"encoder.layers.{i}"
        out.append((f"{e}.self_attn.in_proj_weight", (3 * dim, dim),
                    "xavier", dim))
        out.append((f"{e}.self_attn.in_proj_bias", (3 * dim,), "norm_b", dim))
        _linear(out, f"{e}.self_attn.out_proj", dim, dim)
        _linear(out, f"{e}.linear1", dim, ffn)
        _linear(out, f"{e}.linear2", ffn, dim)
        _norm(out, f"{e}.norm1", dim)
        _norm(out, f"{e}.norm2", dim)
    _linear(out, "proj", dim, int(cfg["proj_dim"]))
    return out


def stage_channels(voc: dict, i: int) -> int:
    return int(voc["upsample_initial_channel"]) // (2 ** (i + 1))


def noise_conv_geometry(voc: dict, i: int):
    """(kernel, stride, padding) of NSF stage ``i``'s noise conv."""
    rates = voc["upsample_rates"]
    if i + 1 < len(rates):
        s = 1
        for r in rates[i + 1:]:
            s *= int(r)
        return 2 * s, s, s // 2
    return 1, 1, 0


def generator(voc: dict, use_nsf: bool = True) -> list:
    """HiFi-GAN V1 generator with the NSF source (openvpi
    ``modules/nsf_hifigan/models.py``), weight norm folded."""
    c0 = int(voc["upsample_initial_channel"])
    out = []
    _conv(out, "conv_pre", int(voc["num_mels"]), c0, 7)
    ch = c0
    n_k = len(voc["resblock_kernel_sizes"])
    for i, (u, k) in enumerate(zip(voc["upsample_rates"],
                                   voc["upsample_kernel_sizes"])):
        c = stage_channels(voc, i)
        _convt(out, f"ups.{i}", ch, c, int(k))
        if use_nsf:
            _conv(out, f"noise_convs.{i}", 1, c, noise_conv_geometry(voc, i)[0])
        for j, (k_rb, d_rb) in enumerate(zip(voc["resblock_kernel_sizes"],
                                             voc["resblock_dilation_sizes"])):
            for d in range(len(d_rb)):
                _conv(out, f"resblocks.{i * n_k + j}.convs1.{d}", c, c, k_rb)
                _conv(out, f"resblocks.{i * n_k + j}.convs2.{d}", c, c, k_rb)
        ch = c
    if use_nsf:
        _linear(out, "m_source.l_linear", int(voc["harmonic_num"]) + 1, 1)
    _conv(out, "conv_post", ch, 1, 7)
    return out


def pe(hp: dict, conv_layers: int = 2) -> list:
    """diff-svc's PitchExtractor (``modules/fastspeech/pe.py``): the conv
    prenet with BatchNorm (its running statistics included), the
    ConvStacks encoder, the pitch predictor."""
    h, m = int(hp["hidden_size"]), int(hp["audio_num_mel_bins"])
    ph = int(hp.get("predictor_hidden", -1))
    ph = ph if ph > 0 else h
    k = int(hp.get("predictor_kernel", 5))
    out, c_in = [], m
    for i in range(3):
        _conv(out, f"mel_prenet.layers.{i}.0", c_in, h, 5)
        _norm(out, f"mel_prenet.layers.{i}.2", h)
        out.append((f"mel_prenet.layers.{i}.2.running_mean", (h,), "norm_b",
                    h))
        out.append((f"mel_prenet.layers.{i}.2.running_var", (h,), "var", h))
        out.append((f"mel_prenet.layers.{i}.2.num_batches_tracked", (),
                    "count", 1))
        c_in = h
    _linear(out, "mel_prenet.out_proj", h, h)
    _linear(out, "mel_encoder.in_proj", h, h)
    for j in range(conv_layers):
        _conv(out, f"mel_encoder.conv.{j}.conv.conv", h, h, 5)
        _norm(out, f"mel_encoder.conv.{j}.norm", h)
    _linear(out, "mel_encoder.out_proj", h, h)
    c_in = h
    for i in range(5):
        _conv(out, f"pitch_predictor.conv.{i}.1", c_in, ph, k)
        _norm(out, f"pitch_predictor.conv.{i}.3", ph)
        c_in = ph
    _linear(out, "pitch_predictor.linear", ph, 2)
    out.append(("pitch_predictor.pos_embed_alpha", (1,), "norm_w", 1))
    return out
