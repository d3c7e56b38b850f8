"""Shared helpers for the torch-port tests (no JAX imports here: the
subprocess test runs them in a process that must stay JAX-free).

The tiny project: the reference-format checkpoints of
``diffsvc_tpu_torch.utils.synth`` at small widths, with no HuBERT file
(``fake_units`` stands in for the units).
"""

import functools

import numpy as np

from diffsvc_tpu_torch.utils import synth

SR = 8000
HOP = 64
MEL = 16
HID = 32

TINY_HP = dict(
    audio_sample_rate=SR, audio_num_mel_bins=MEL, keep_bins=MEL, fft_size=256,
    hop_size=HOP, win_size=256, fmin=40, fmax=4000, f0_min=40.0,
    f0_max=1100.0, f0_bin=256, hidden_size=HID, residual_layers=4,
    residual_channels=32, dilation_cycle_length=4, timesteps=50, K_step=50,
    schedule_type="linear", max_beta=0.02, spec_min=[-5.0], spec_max=[0.0],
    mel_vmin=-6.0, mel_vmax=1.5, pndm_speedup=10, use_nsf=True,
    use_pitch_embed=True, use_energy_embed=False, no_fs2=True,
    pitch_norm="log", use_uv=False, use_crepe=False, use_vec=False,
    pe_enable=False, pe_ckpt="", wav_bucket_frames=128, max_frames=42000,
    max_input_tokens=60000, sampler="plms", diff_compute_dtype="",
    binarization_args=dict(with_f0=True, with_hubert=True, with_align=True),
)

TINY_VOC = dict(
    num_mels=MEL, upsample_initial_channel=256, upsample_rates=[4, 4, 4],
    upsample_kernel_sizes=[8, 8, 8], resblock="1",
    resblock_kernel_sizes=[3, 5], resblock_dilation_sizes=[[1, 3], [1, 3]],
    sampling_rate=SR, n_fft=256, win_size=256, hop_size=HOP, fmin=40,
    fmax=4000)

voiced_wav = functools.partial(synth.voiced_wav, sr=SR)


def write_project(root):
    """Tiny project under ``root``: checkpoints + config.yaml.  Returns
    (config path, diffusion ckpt path)."""
    config = dict(TINY_HP,
                  vocoder="diffsvc_tpu.vocoders.nsf_hifigan.NsfHifiGAN")
    return synth.write_project(root, config, TINY_VOC)


def fake_units(wav_path, dim=HID):
    """Deterministic stand-in for HuBERT units ([T, dim] at the 320x frame
    rate of the 16 kHz resample), shared by both implementations."""
    from diffsvc_tpu_torch.utils.audio_io import load_wav

    if hasattr(wav_path, "seek"):
        wav_path.seek(0)
    wav, _ = load_wav(wav_path, sr=16000)
    n = max(len(wav) // 320, 1)
    return np.random.RandomState(n).randn(n, dim).astype(np.float32) * 0.3
