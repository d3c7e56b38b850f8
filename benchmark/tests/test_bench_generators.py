"""Each cell's traffic is a function of the seed: the same seed gives the
same inputs, another seed other contents over the same sizes."""

import numpy as np

from benchmark import harness
from benchmark.tests import tiny


def test_songs_deterministic():
    gen = harness.load_module("generators", "song")
    mix = tiny.song_mix(3)
    a = gen.songs(mix, 123456789012, 8000)
    b = gen.songs(mix, 123456789012, 8000)
    c = gen.songs(mix, 7, 8000)
    assert [x[:2] for x in a] == [x[:2] for x in b]
    # the same sizes in the same order for every seed
    assert [x[:2] for x in a] == [x[:2] for x in c]
    pa, ka = gen.render(mix, a[0][2], 123456789012, a[0][0], 8000)
    pb, kb = gen.render(mix, b[0][2], 123456789012, b[0][0], 8000)
    pc, _ = gen.render(mix, a[0][2], 7, a[0][0], 8000)
    assert ka == kb and np.array_equal(pa, pb)
    assert not np.array_equal(pa, pc)


def test_corpus_deterministic():
    gen = harness.load_module("generators", "corpus")
    ov = tiny.train_overrides()
    hp, mix = ov["config"]["hparams"], ov["traffic"]
    a, b, c = (gen.items(mix, hp, s) for s in (5, 5, 6))
    assert [len(x["mel"]) for x in a] == [len(x["mel"]) for x in c]
    for x, y in zip(a, b):
        for k in ("mel", "f0", "hubert", "mel2ph", "pitch"):
            assert np.array_equal(x[k], y[k])
    assert not np.array_equal(a[0]["mel"], c[0]["mel"])
