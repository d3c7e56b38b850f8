"""Indexed binary dataset: one ``.data`` file of raw pickles + ``.idx`` npy
of byte offsets. O(1) random access with a small LRU cache.

On-disk format is byte-identical to the reference
(``utils/indexed_datasets.py:7-54``) so binarized datasets are
interchangeable between the two frameworks. Reading uses mmap (zero-copy
seeks).

A copy of ``diffsvc_tpu/data/indexed_datasets.py``: that package's
``data/__init__.py`` imports JAX, and the port never does.
"""

from __future__ import annotations

import mmap
import pickle
from copy import deepcopy

import numpy as np


class IndexedDataset:
    def __init__(self, path: str, num_cache: int = 1):
        self.path = path
        self.data_offsets = np.load(f"{path}.idx", allow_pickle=True).item()["offsets"]
        self._file = open(f"{path}.data", "rb")
        try:
            self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        except ValueError:  # empty file
            self._mm = None
        self.cache = []
        self.num_cache = num_cache

    def check_index(self, i: int):
        if i < 0 or i >= len(self.data_offsets) - 1:
            raise IndexError("index out of range")

    def __del__(self):
        if getattr(self, "_mm", None) is not None:
            self._mm.close()
        if getattr(self, "_file", None) is not None:
            self._file.close()

    def __getitem__(self, i: int):
        self.check_index(i)
        if self.num_cache > 0:
            for c in self.cache:
                if c[0] == i:
                    return c[1]
        b = self._mm[self.data_offsets[i]: self.data_offsets[i + 1]]
        item = pickle.loads(b)
        if self.num_cache > 0:
            self.cache = [(i, deepcopy(item))] + self.cache[:-1]
        return item

    def __len__(self):
        return len(self.data_offsets) - 1


class IndexedDatasetBuilder:
    def __init__(self, path: str):
        self.path = path
        self.out_file = open(f"{path}.data", "wb")
        self.byte_offsets = [0]

    def add_item(self, item) -> None:
        s = pickle.dumps(item)
        n = self.out_file.write(s)
        self.byte_offsets.append(self.byte_offsets[-1] + n)

    def finalize(self) -> None:
        self.out_file.close()
        np.save(open(f"{self.path}.idx", "wb"), {"offsets": self.byte_offsets})
