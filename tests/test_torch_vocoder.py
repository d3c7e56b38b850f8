"""The (NSF-)HiFiGAN generator and K3 (the generator tail) in the torch port
against the JAX package on the CPU.

Weights: the torch module's state dict through the JAX package's converter
(``convert_torch.convert_hifigan_generator``).  The NSF
source randomness is JAX's own draw (``sine_gen_ht``: uniform initial phases
and unit noise from ``split(rng)``), handed to the port through
``*_from_randoms``, so both sides synthesize from the same source.
Tolerance 2e-4 on the tanh waveform, as tests/test_vocoder_tail.py allows
the TPU tail against the plain generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffsvc_tpu.ops.pallas import vocoder_tail as jvt
from diffsvc_tpu.utils import convert_torch as cvt
from diffsvc_tpu.vocoders import generator as jgen
from diffsvc_tpu_torch.vocoders import generator as tgen

CFG_S0 = dict(num_mels=16, upsample_initial_channel=256,
              upsample_rates=(8, 2, 2), upsample_kernel_sizes=(16, 4, 4),
              resblock="1", resblock_kernel_sizes=(3, 7),
              resblock_dilation_sizes=((1, 3), (1, 2)), sampling_rate=8000,
              use_nsf=True, harmonic_num=4)
CFG_S1 = dict(CFG_S0, upsample_initial_channel=512, upsample_rates=(4, 2, 2),
              upsample_kernel_sizes=(8, 4, 4), resblock_kernel_sizes=(3,),
              resblock_dilation_sizes=((1, 3, 5),))
CFG_RB2 = dict(CFG_S0, resblock="2", use_nsf=False)
CFGS = {"nsf-s0": CFG_S0, "nsf-s1": CFG_S1, "rb2-plain": CFG_RB2}


def _pair(cfg_kw, seed=0):
    """Torch default init from ``seed``; the JAX side gets the same weights
    through the JAX package's checkpoint converter."""
    jcfg = jgen.HifiGanConfig(**cfg_kw)
    torch.manual_seed(seed)
    gen = tgen.Generator(tgen.HifiGanConfig(**cfg_kw))
    sd = {k: v.numpy() for k, v in gen.state_dict().items()}
    return jcfg, cvt.convert_hifigan_generator(sd, jcfg), gen


def _inputs(cfg_kw, t0=20, b=1, seed=1):
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(seed), 3)
    mel = jax.random.normal(k1, (b, t0, cfg_kw["num_mels"]))
    f0 = 100.0 + 80.0 * jax.random.uniform(k2, (b, t0))
    f0 = f0 * (jax.random.uniform(k3, (b, t0)) > 0.3)   # some unvoiced
    return mel, f0, jax.random.PRNGKey(7)


def _jax_randoms(rng, b, length, harmonic_num):
    """The draws jax sine_gen_ht makes from ``rng``."""
    h = harmonic_num + 1
    k1, k2 = jax.random.split(rng)
    rand_ini = jax.random.uniform(k1, (b, h), dtype=jnp.float32)
    unit_noise = jax.random.normal(k2, (b, h, length), jnp.float32)
    return (torch.from_numpy(np.array(rand_ini)),
            torch.from_numpy(np.array(unit_noise)))


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


@pytest.mark.parametrize("name", list(CFGS))
def test_apply_matches_jax(name):
    cfg_kw = CFGS[name]
    jcfg, params, gen = _pair(cfg_kw)
    mel, f0, rng = _inputs(cfg_kw)
    use_f0 = cfg_kw["use_nsf"]
    ref = jax.jit(lambda p, m, f, r: jgen.apply(p, jcfg, m, f, r))(
        params, mel, f0 if use_f0 else None, rng)
    randoms = _jax_randoms(rng, 1, 20 * int(np.prod(cfg_kw["upsample_rates"])),
                           cfg_kw["harmonic_num"])
    with torch.no_grad():
        got = tgen.apply(gen, _t(mel), _t(f0) if use_f0 else None, randoms)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


@pytest.mark.parametrize("name", list(CFGS))
def test_serving_tail_matches_jax_tail_interpret(name):
    """K3's plain version (through apply_serving) vs the TPU tail kernel in
    interpret mode with f32 taps, multi-tile (ts=24) and ragged."""
    cfg_kw = CFGS[name]
    jcfg, params, gen = _pair(cfg_kw)
    packed = jgen.pack_params(params, jcfg, 128)
    plan, tp = jgen.build_tail_params(params, packed, jcfg, 128,
                                      weight_dtype=jnp.float32)
    assert tgen.tail_start_stage(gen.cfg) == plan.s0
    mel, f0, rng = _inputs(cfg_kw)
    use_f0 = cfg_kw["use_nsf"]
    ref = jgen.apply_tail(tp, jcfg, mel, f0 if use_f0 else None,
                          rng if use_f0 else None, plan=plan, ts=24,
                          interpret=True)
    randoms = _jax_randoms(rng, 1, 20 * int(np.prod(cfg_kw["upsample_rates"])),
                           cfg_kw["harmonic_num"])
    with torch.no_grad():
        got = tgen.apply_serving(gen, _t(mel), _t(f0) if use_f0 else None,
                                 randoms)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_serving_batch_matches_per_sample():
    """The port's tail takes B > 1 (the TPU kernel is B=1)."""
    cfg_kw = CFG_S1
    _, _, gen = _pair(cfg_kw)
    mel, f0, _ = _inputs(cfg_kw, b=2)
    length = 20 * int(np.prod(cfg_kw["upsample_rates"]))
    randoms = tgen.draw_randoms(2, length, cfg_kw["harmonic_num"],
                                torch.Generator().manual_seed(0))
    with torch.no_grad():
        both = tgen.apply_serving(gen, _t(mel), _t(f0), randoms)
        for i in range(2):
            one = tgen.apply_serving(gen, _t(mel)[i:i + 1], _t(f0)[i:i + 1],
                                     (randoms[0][i:i + 1],
                                      randoms[1][i:i + 1]))
            np.testing.assert_allclose(both[i:i + 1].numpy(), one.numpy(),
                                       atol=1e-6)


def test_tail_start_stage_openvpi_geometry():
    cfg = tgen.HifiGanConfig(num_mels=128, upsample_initial_channel=512,
                             upsample_rates=(8, 8, 2, 2, 2),
                             upsample_kernel_sizes=(16, 16, 4, 4, 4),
                             sampling_rate=44100, use_nsf=True)
    jcfg = jgen.HifiGanConfig(**cfg._asdict())
    assert tgen.tail_start_stage(cfg) == jvt.kernel_start_stage(jcfg) == 1
