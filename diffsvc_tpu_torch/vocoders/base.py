"""Vocoder registry + duck-typed interface.

Counterpart of ``diffsvc_tpu/vocoders/base.py`` (reference
``network/vocoders/base_vocoder.py:2-39``): classes register under their
name and lowercase name; a config's dotted path (``diffsvc_tpu.vocoders.
nsf_hifigan.NsfHifiGAN``, ``network.vocoders...``) resolves by its last
component to the port's class of that name.
"""

from __future__ import annotations

VOCODERS = {}


def register_vocoder(cls):
    VOCODERS[cls.__name__.lower()] = cls
    VOCODERS[cls.__name__] = cls
    return cls


def get_vocoder_cls(hp):
    from . import hifigan, nsf_hifigan  # noqa: F401  (register the classes)

    name = str(hp["vocoder"])
    short = name.split(".")[-1]
    for key in (name, short, short.replace("_", "").lower()):
        if key in VOCODERS:
            return VOCODERS[key]
    raise NotImplementedError(f"vocoder {name!r} is not ported to torch yet "
                              f"(available: {sorted(set(VOCODERS))})")


class BaseVocoder:
    def spec2wav(self, mel, **kwargs):
        """:param mel: [T, M] log10-mel; :return: wav [T']"""
        raise NotImplementedError

    @staticmethod
    def wav2spec(wav_fn, hp=None):
        """:param wav_fn: path; :return: (wav, mel [T, M])"""
        raise NotImplementedError
