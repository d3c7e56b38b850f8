"""Token-budget batching + size-sorted shuffling + data-parallel sharding.

Parity targets:
- ``batch_by_size`` (reference utils/__init__.py:89-142): greedy batching
  under max_tokens/max_sentences with a batch-size-multiple rule,
- ``ordered_indices`` (training/dataset/base_dataset.py:52-62): random
  permutation then *stable* sort by length,
- the DDP shard rule (training/task/tts.py:85-88): each rank takes a
  stride-slice of every batch; batches not divisible by world size drop.

A copy of ``diffsvc_tpu/data/batching.py``: that package's
``data/__init__.py`` imports JAX, and the port never does.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional

import numpy as np


def ordered_indices(sizes, shuffle: bool, sort_by_len: bool,
                    rng: Optional[np.random.RandomState] = None) -> np.ndarray:
    sizes = np.asarray(sizes)
    if shuffle:
        rng = rng or np.random
        indices = rng.permutation(len(sizes))
        if sort_by_len:
            indices = indices[np.argsort(sizes[indices], kind="mergesort")]
    else:
        indices = np.arange(len(sizes))
    return indices


def _is_batch_full(batch, num_tokens, max_tokens, max_sentences):
    if len(batch) == 0:
        return False
    if len(batch) == max_sentences:
        return True
    if num_tokens > max_tokens:
        return True
    return False


def batch_by_size(indices, num_tokens_fn: Callable[[int], int],
                  max_tokens: Optional[int] = None,
                  max_sentences: Optional[int] = None,
                  required_batch_size_multiple: int = 1) -> List[List[int]]:
    max_tokens = max_tokens if max_tokens is not None else sys.maxsize
    max_sentences = max_sentences if max_sentences is not None else sys.maxsize
    bsz_mult = required_batch_size_multiple

    sample_len = 0
    sample_lens: List[int] = []
    batch: List[int] = []
    batches: List[List[int]] = []
    for idx in indices:
        idx = int(idx)
        num_tokens = num_tokens_fn(idx)
        sample_lens.append(num_tokens)
        sample_len = max(sample_len, num_tokens)
        assert sample_len <= max_tokens, (
            f"sentence at index {idx} of size {sample_len} exceeds max_tokens "
            f"limit of {max_tokens}!")
        num_tokens = (len(batch) + 1) * sample_len
        if _is_batch_full(batch, num_tokens, max_tokens, max_sentences):
            mod_len = max(bsz_mult * (len(batch) // bsz_mult),
                          len(batch) % bsz_mult)
            batches.append(batch[:mod_len])
            batch = batch[mod_len:]
            sample_lens = sample_lens[mod_len:]
            sample_len = max(sample_lens) if sample_lens else 0
        batch.append(idx)
    if batch:
        batches.append(batch)
    return batches


def shard_batches(batches: List[List[int]], num_replicas: int,
                  rank: int = 0) -> List[List[int]]:
    """Data-parallel shard: stride-slice every batch; drop indivisible ones.

    With a single global program feeding all devices (the TPU model), call
    with rank=0..num_replicas-1 to build per-device sub-batches, or use
    ``pad_batch_to_multiple`` and feed whole batches with a sharded leading
    axis.
    """
    if num_replicas <= 1:
        return batches
    return [x[rank::num_replicas] for x in batches if len(x) % num_replicas == 0]


def filter_divisible(batches: List[List[int]], num_replicas: int) -> List[List[int]]:
    """Keep only batches whose size divides the data-parallel axis (the same
    acceptance rule as the reference's DDP shard)."""
    if num_replicas <= 1:
        return batches
    return [x for x in batches if len(x) % num_replicas == 0]
