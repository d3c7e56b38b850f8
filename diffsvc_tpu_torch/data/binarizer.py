"""Offline binarization: raw wav tree -> indexed binary splits.

Counterpart of ``diffsvc_tpu/data/binarizer.py:40-214`` (reference
``preprocessing/base_binarizer.py`` and ``preprocessing/SVCpre.py``):

- items: every ``*.wav`` / ``*.ogg`` under ``raw_data_dir`` (with
  ``use_spk_id`` and ``num_spk > 1``, each first-level subdirectory is a
  speaker);
- split: the last 5 items are test = valid (or ``test_prefixes`` with
  ``choose_test_manually``), the rest train;
- per split, valid then test then train, items in reverse order through
  ``features.process_item`` (mel and f0 on the device: CREPE with
  ``use_crepe``, falling back to the AC tracker without its weights, as
  the JAX binarizer does; units from the port's HuBERT encoder; the f0
  track cache with ``f0_cache_dir``) into an ``IndexedDatasetBuilder``, or,
  with ``binarize_batch_size`` > 1, no ``use_crepe`` and an encoder with
  weights, through ``features.process_items_batched`` in groups of that
  size (one AC track and one encoder call per group; JAX's gate,
  ``diffsvc_tpu/data/binarizer.py:114-133``);
- the train split's spec_min / spec_max written back into the YAML config
  (``write_back_spec_stats``), ``{prefix}_lengths.npy`` and ``spk_map.json``.
"""

from __future__ import annotations

import json
import os
import random
from copy import deepcopy
from pathlib import Path
from typing import Dict, List

import numpy as np

from ..config.hparams import write_back_spec_stats
from . import features
from .indexed_datasets import IndexedDatasetBuilder


class SVCBinarizer:
    def __init__(self, hp, device="cpu"):
        self.hp = hp
        self.device = device
        self.binarization_args = hp["binarization_args"]
        self.items: Dict[str, Dict] = self.load_meta_data()
        self.item_names = sorted(self.items)
        if self.binarization_args.get("shuffle"):
            random.seed(1234)
            random.shuffle(self.item_names)
        self.train_item_names, self.test_item_names = \
            self.split_train_test_set(self.item_names)
        self.valid_item_names = self.test_item_names

    def load_meta_data(self) -> Dict[str, Dict]:
        raw = Path(self.hp["raw_data_dir"])
        files = list(raw.rglob("*.wav")) + list(raw.rglob("*.ogg"))
        multi_spk = bool(self.hp.get("use_spk_id")) \
            and int(self.hp.get("num_spk", 1)) > 1

        def spk_of(fn: Path) -> str:
            rel = fn.relative_to(raw)
            if multi_spk and len(rel.parts) > 1:
                return rel.parts[0]
            return str(self.hp.get("speaker_id", 0))

        return {str(fn): {"wav_fn": str(fn), "spk_id": spk_of(fn)}
                for fn in files}

    def split_train_test_set(self, item_names: List[str]):
        item_names = deepcopy(item_names)
        if self.hp.get("choose_test_manually"):
            test = [x for x in item_names if any(
                x.startswith(ts) for ts in self.hp["test_prefixes"])]
        else:
            test = item_names[-5:]
        train = [x for x in item_names if x not in set(test)]
        print(f"| train {len(train)} test {len(test)}")
        return train, test

    def build_spk_map(self) -> Dict[str, int]:
        spk_map = sorted({self.items[n]["spk_id"] for n in self.item_names})
        if len(spk_map) > self.hp["num_spk"]:
            raise ValueError(f"{len(spk_map)} speakers, num_spk is "
                             f"{self.hp['num_spk']}")
        return {x: i for i, x in enumerate(spk_map)}

    def _phone_encoder(self):
        from ..infer.hubert_encoder import Hubertencoder

        return Hubertencoder(self.hp["hubert_path"], hp=self.hp,
                             device=self.device)

    def process(self) -> None:
        hp = self.hp
        os.makedirs(hp["binary_data_dir"], exist_ok=True)
        self.spk_map = self.build_spk_map()
        print("| spk_map: ", self.spk_map)
        with open(f"{hp['binary_data_dir']}/spk_map.json", "w",
                  encoding="utf-8") as f:
            json.dump(self.spk_map, f)
        self.phone_encoder = self._phone_encoder()
        for prefix in ("valid", "test", "train"):
            self.process_data_split(prefix)

    def process_data_split(self, prefix: str) -> None:
        hp = self.hp
        data_dir = hp["binary_data_dir"]
        names = {"valid": self.valid_item_names,
                 "test": self.test_item_names}.get(prefix,
                                                   self.train_item_names)
        builder = IndexedDatasetBuilder(f"{data_dir}/{prefix}")
        lengths, spec_min, spec_max = [], [], []
        total_sec = 0.0
        for item in self.processed_items(names):
            if item is None:
                continue
            spec_min.append(item["spec_min"])
            spec_max.append(item["spec_max"])
            if not self.binarization_args.get("with_wav"):
                del item["wav"]
            builder.add_item(item)
            lengths.append(item["len"])
            total_sec += item["sec"]
        if prefix == "train" and spec_min:
            write_back_spec_stats(hp, np.min(spec_min, 0).tolist(),
                                  np.max(spec_max, 0).tolist())
        builder.finalize()
        np.save(f"{data_dir}/{prefix}_lengths.npy", lengths)
        print(f"| {prefix} total duration: {total_sec:.3f}s "
              f"({len(lengths)} items)")

    def processed_items(self, names: List[str]):
        """The split's items in reverse order (None for a skipped one):
        batched when ``binarize_batch_size`` > 1, the tracker is the AC one
        and the encoder has weights for ``encode_batch``, else one by one
        (and said so when a batch size was asked for)."""
        hp, enc = self.hp, self.phone_encoder
        metas = [(name, self.items[name]["wav_fn"]) for name in
                 reversed(names)]
        spk_ids = [self.spk_map[self.items[name]["spk_id"]]
                   for name, _ in metas]
        batch_size = int(hp.get("binarize_batch_size", 8) or 0)
        if batch_size > 1 and not hp.get("use_crepe", False):
            if hasattr(enc, "encode_batch") \
                    and getattr(enc, "model", None) is not None:
                for _, item in features.process_items_batched(
                        metas, hp, enc.encode_batch, self.binarization_args,
                        spk_ids=spk_ids, group_size=batch_size,
                        device=self.device):
                    yield item
                return
            print(f"| binarize_batch_size {batch_size}: the content encoder "
                  "has no weights for encode_batch; items go one by one")
        for (name, wav_fn), spk_id in zip(metas, spk_ids):
            yield features.process_item(
                name, wav_fn, hp, enc.encode, self.binarization_args,
                spk_id=spk_id, device=self.device,
                tg_fn=self.items[name].get("tg_fn"),
                ph=self.items[name].get("ph"))


def binarize(hp, device=None) -> None:
    """CLI body (reference ``preprocessing/binarize.py``): the configured
    ``binarizer_cls`` must be the SVC binarizer, the one that is ported.
    Features run on ``device``, by default the card (``default_device``)."""
    name = str(hp.get("binarizer_cls", "SVCBinarizer"))
    if not name.endswith("SVCBinarizer"):
        raise NotImplementedError(f"binarizer_cls {name} is not ported to "
                                  "torch (SVCBinarizer is)")
    from ..infer.svc import default_device

    SVCBinarizer(hp, device=default_device(device)).process()
