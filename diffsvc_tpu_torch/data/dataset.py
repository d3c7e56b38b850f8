"""Training dataset over binarized splits + batch iterator.

Counterpart of ``diffsvc_tpu/data/dataset.py`` (reference
``training/dataset/fs2_utils.py`` FastSpeechDataset and the dataloader
assembly in ``training/task/tts.py:49-93``): token-budget bucketing over
size-sorted shuffled indices, ``endless_ds`` repetition, and the
divisibility rule for the data-parallel axis.

Batches are numpy dicts collated on the host (the same indices and the same
padded arrays as the JAX package for the same seed); the task moves them to
the device.  Lengths are padded to ``pad_multiple`` like the JAX package's.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional

import numpy as np

from ..config import HParams
from ..utils import trace
from . import features
from .indexed_datasets import IndexedDataset
from .batching import batch_by_size, ordered_indices


class FastSpeechDataset:
    def __init__(self, prefix: str, hp: HParams, shuffle: bool = False):
        self.prefix = prefix
        self.hp = hp
        self.shuffle = shuffle
        self.sort_by_len = bool(hp.get("sort_by_len", True))
        self.data_dir = hp["binary_data_dir"]
        self.sizes = np.load(f"{self.data_dir}/{prefix}_lengths.npy")
        self.indexed_ds: Optional[IndexedDataset] = None

        f0_stats_fn = f"{self.data_dir}/train_f0s_mean_std.npy"
        if os.path.exists(f0_stats_fn):
            hp["f0_mean"], hp["f0_std"] = [float(v) for v in np.load(f0_stats_fn)]

        if prefix == "test" and hp.get("num_test_samples", 0) > 0:
            self.avail_idxs = (list(range(hp["num_test_samples"]))
                               + list(hp.get("test_ids", [])))
            self.sizes = [self.sizes[i] for i in self.avail_idxs]
        else:
            self.avail_idxs = None

    def _get_item(self, index: int) -> Dict:
        if self.avail_idxs is not None:
            index = self.avail_idxs[index]
        if self.indexed_ds is None:
            self.indexed_ds = IndexedDataset(f"{self.data_dir}/{self.prefix}")
        return self.indexed_ds[index]

    def __len__(self):
        return len(self.sizes)

    def __getitem__(self, index: int) -> Dict:
        item = self._get_item(index)
        sample = features.getitem(item, self.hp)
        sample["id"] = index
        return sample

    def size(self, index: int) -> int:
        return min(self.sizes[index], self.hp.get("max_frames", 42000))

    def num_tokens(self, index: int) -> int:
        return self.size(index)

    def collater(self, samples: List[Dict], pad_multiple: int = 1) -> Dict:
        return features.processed_input2batch(samples, self.hp, pad_multiple)

    def ordered_indices(self, rng=None) -> np.ndarray:
        return ordered_indices(self.sizes, self.shuffle, self.sort_by_len, rng)


def build_batches(dataset: FastSpeechDataset, hp: HParams, num_replicas: int = 1,
                  shuffle_batches: bool = True,
                  rng: Optional[np.random.RandomState] = None) -> List[List[int]]:
    """Assemble bucketed index batches (training/task/tts.py:49-88)."""
    rng = rng or np.random.RandomState(hp.get("seed", 1234))
    max_tokens = hp.get("max_tokens", 128000) * max(num_replicas, 1)
    max_sentences = hp.get("max_sentences", 88) * max(num_replicas, 1)
    indices = dataset.ordered_indices(rng)
    batches = batch_by_size(indices, dataset.num_tokens,
                            max_tokens=max_tokens, max_sentences=max_sentences,
                            required_batch_size_multiple=max(num_replicas, 1))
    if hp.get("endless_ds"):
        batches = batches * 1000
    if shuffle_batches:
        rng.shuffle(batches)
    # indivisible remainder batches are padded by the trainer (sample_mask),
    # not dropped — no data loss vs the reference's DDP drop rule
    return batches


class BatchIterator:
    """Host-side batch producer: indices -> padded numpy batch dicts."""

    def __init__(self, dataset: FastSpeechDataset, batches: List[List[int]],
                 pad_multiple: int = 128, pad_batch_to: Optional[int] = None):
        self.dataset = dataset
        self.batches = batches
        self.pad_multiple = pad_multiple
        self.pad_batch_to = pad_batch_to

    def __len__(self):
        return len(self.batches)

    def __iter__(self) -> Iterator[Dict]:
        for idxs in self.batches:
            samples = [self.dataset[i] for i in idxs]
            batch = self.dataset.collater(samples, self.pad_multiple)
            if self.pad_batch_to and batch["nsamples"] < self.pad_batch_to:
                batch = _pad_batch_dim(batch, self.pad_batch_to)
            yield batch


def prefetch(iterator: Iterator, prepare_fn=None, depth: int = 2) -> Iterator:
    """Run the (host-side) batch pipeline a few steps ahead in a background
    thread — collation/padding/device transfer overlap device compute.

    Spans and counters (``utils/trace.py``): the producer records
    ``data.collate`` around each item (the iterator's step and
    ``prepare_fn``); the consumer counts ``data.gets`` per item and
    ``data.gets_empty`` where the queue held none when it asked."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    _END = object()
    _ERR = object()

    def producer():
        try:
            it = iter(iterator)
            while True:
                with trace.span("data.collate"):
                    item = next(it, _END)
                    if item is not _END and prepare_fn:
                        item = prepare_fn(item)
                q.put(item)
                if item is _END:
                    break
        except BaseException as e:  # re-raised in the consumer — a data
            # error must NOT be reported as a clean end-of-epoch
            q.put((_ERR, e))

    t = threading.Thread(target=producer, daemon=True)
    t.start()
    while True:
        empty = trace.on() and q.empty()
        item = q.get()
        if item is _END:
            break
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _ERR:
            raise item[1]
        trace.count("data.gets")
        if empty:
            trace.count("data.gets_empty")
        yield item


def _pad_batch_dim(batch: Dict, n: int) -> Dict:
    """Pad the batch axis with zero rows; a ``sample_mask`` marks real rows
    so the loss ignores the padding."""
    real = batch["nsamples"]
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == real:
            pad = [(0, n - v.shape[0])] + [(0, 0)] * (v.ndim - 1)
            out[k] = np.pad(v, pad)
        else:
            out[k] = v
    out["sample_mask"] = (np.arange(n) < real).astype(np.float32)
    out["nsamples"] = n
    return out
