"""Conceptual Captions pretraining pipeline.

The port's own copy of ``vilbert_tpu/data/concap.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

Host-side rebuild of the reference tensorpack/ZMQ pipeline
(vilbert/datasets/concept_cap_dataset.py:154-670): per-sample caption
negative swap, BERT token masking, region masking with IoU>0.4 co-masking,
padding, and batch assembly with the prepended global image feature.

Design differences (TPU-first):
- a seeded ``np.random.Generator`` per (epoch, index) instead of global
  ``random`` state — fully reproducible and shardable across hosts,
- batches are dicts of numpy arrays (static shapes) handed to a
  double-buffered device prefetcher (vilbert_tpu_torch.data.prefetch),
- masking math is vectorized numpy per sample; the multi-worker ZMQ fleet is
  unnecessary on TPU hosts (and harmful on single-core VMs).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from vilbert_tpu_torch.data.boxes import iou
from vilbert_tpu_torch.data.feature_store import FeatureStore, RegionFeatures
from vilbert_tpu_torch.data.tokenization import Tokenizer, add_special_single

#: Conceptual Captions train-set size (reference constant,
#: concept_cap_dataset.py:196)
CONCEPTUAL_CAPTIONS_TRAIN_SIZE = 3_119_449


@dataclass
class ConceptCapSampleConfig:
    seq_len: int = 36
    region_len: int = 36
    feature_dim: int = 2048
    target_dim: int = 1601
    visual_target: int = 0   # 0: soft detector dist; 1/2: feature itself
    objective: int = 0
    visualization: bool = False


class ConceptCapPreprocessor:
    """Per-sample preprocessing (reference BertPreprocessBatch,
    concept_cap_dataset.py:400-670)."""

    def __init__(
        self,
        tokenizer: Tokenizer,
        captions: Sequence[str],
        cfg: ConceptCapSampleConfig = ConceptCapSampleConfig(),
        token_cache_size: int = 1 << 22,
    ):
        self.tokenizer = tokenizer
        self.captions = list(captions)
        self.cfg = cfg
        # caption string -> token ids; captions repeat every epoch (and the
        # negative-sampling pool is reused constantly) — the reference
        # re-tokenizes every time (concept_cap_dataset.py:538-550)
        self._token_cache: dict = {}
        self._token_cache_size = token_cache_size

    def encode_cached(self, caption: str):
        ids = self._token_cache.get(caption)
        if ids is None:
            ids = tuple(self.tokenizer.encode(caption))
            if len(self._token_cache) < self._token_cache_size:
                self._token_cache[caption] = ids
        return ids

    # -- steps --------------------------------------------------------------

    def random_cap(self, caption: str, rng: np.random.Generator):
        """50% caption swap for the alignment objective
        (concept_cap_dataset.py:498-515). Returns (caption, is_next) with
        is_next=1 meaning misaligned."""
        if self.cfg.visualization:
            return caption, 0
        if self.cfg.objective != 2 and rng.random() > 0.5:
            return self.captions[rng.integers(0, len(self.captions))], 1
        return caption, 0

    def random_word(self, ids: List[int], rng: np.random.Generator):
        """BERT 15% masking, 80/10/10 (concept_cap_dataset.py:608-636).
        Vectorized: one probability draw per token, same marginal
        distribution as the reference's sequential draws."""
        if self.cfg.visualization or not ids:
            return ids, [-1] * len(ids)
        arr = np.asarray(ids, np.int64)
        probs = rng.random(len(arr))
        selected = probs < 0.15
        sub = probs / 0.15
        labels = np.where(selected, arr, -1)
        to_mask = selected & (sub < 0.8)
        to_rand = selected & (sub >= 0.8) & (sub < 0.9)
        arr[to_mask] = self.tokenizer.mask_token_id
        n_rand = int(to_rand.sum())
        if n_rand:
            arr[to_rand] = rng.integers(0, self.tokenizer.vocab_size, n_rand)
        return arr.tolist(), labels.tolist()

    def random_region(
        self,
        image_feat: np.ndarray,
        num_boxes: int,
        overlaps: np.ndarray,
        rng: np.random.Generator,
    ):
        """15% region masking, 90% zeroed, with overlap>0.4 co-mask recording
        (concept_cap_dataset.py:638-670). ``overlaps`` covers the first
        ``num_boxes`` rows; outputs span the padded region table. Vectorized."""
        labels = np.full((image_feat.shape[0],), -1, np.int64)
        masked_label = np.zeros((image_feat.shape[0],), bool)
        if self.cfg.visualization or num_boxes == 0:
            return image_feat, labels, masked_label
        k = overlaps.shape[1]
        probs = rng.random(num_boxes)
        selected = probs < 0.15
        zeroed = selected & (probs / 0.15 < 0.9)
        image_feat[:num_boxes][zeroed] = 0
        labels[:num_boxes][selected] = 1
        if selected.any():
            masked_label[:k] = (overlaps[selected] > 0.4).any(axis=0)
        return image_feat, labels, masked_label

    # -- full sample --------------------------------------------------------

    def alloc_batch(self, batch_size: int) -> Dict[str, np.ndarray]:
        """Preallocated batch buffers with the global-feature row reserved
        at region index 0 (filled by finalize_batch)."""
        cfg = self.cfg
        b, t, r = batch_size, cfg.seq_len, cfg.region_len
        return {
            "input_ids": np.zeros((b, t), np.int32),
            "input_mask": np.zeros((b, t), np.int32),
            "segment_ids": np.zeros((b, t), np.int32),
            "lm_label_ids": np.full((b, t), -1, np.int32),
            "is_next": np.zeros((b,), np.int32),
            "image_feat": np.zeros((b, r + 1, cfg.feature_dim), np.float32),
            "image_loc": np.zeros((b, r + 1, 5), np.float32),
            "image_target": np.zeros(
                (b, r, cfg.target_dim if cfg.visual_target == 0
                 else cfg.feature_dim), np.float32,
            ),
            "image_label": np.full((b, r), -1, np.int32),
            "image_mask": np.zeros((b, r + 1), np.int32),
            "masked_label": np.zeros((b, r), bool),
            "image_id": np.zeros((b,), np.int32),
        }

    def fill(
        self,
        out: Dict[str, np.ndarray],
        row: int,
        rf: RegionFeatures,
        caption: str,
        rng: np.random.Generator,
        image_id: str = "",
    ) -> None:
        """Write one preprocessed sample into batch row ``row`` (region rows
        are offset by 1 — row 0 is the global feature slot)."""
        cfg = self.cfg
        n = min(int(rf.features.shape[0]), cfg.region_len)

        feat = out["image_feat"][row, 1:]
        loc = out["image_loc"][row, 1:]
        feat[:n] = rf.features[:n]
        loc[:n, 0] = rf.boxes[:n, 0] / rf.image_w
        loc[:n, 1] = rf.boxes[:n, 1] / rf.image_h
        loc[:n, 2] = rf.boxes[:n, 2] / rf.image_w
        loc[:n, 3] = rf.boxes[:n, 3] / rf.image_h
        # area from the zero-padded table like the reference
        # (concept_cap_dataset.py:445-449)
        loc[:, 4] = (loc[:, 3] - loc[:, 1]) * (loc[:, 2] - loc[:, 0])

        if cfg.visual_target == 0:
            if rf.target is not None:
                out["image_target"][row, :n] = rf.target[:n]
        else:
            out["image_target"][row, :n] = rf.features[:n]

        overlaps = iou(rf.boxes[:n], rf.boxes[:n])

        caption, is_next = self.random_cap(caption, rng)
        ids = list(self.encode_cached(caption))[: cfg.seq_len - 2]
        ids, token_labels = self.random_word(ids, rng)
        _, image_label, masked_label = self.random_region(feat, n, overlaps, rng)

        input_ids = add_special_single(self.tokenizer, ids)
        L = len(input_ids)
        out["input_ids"][row, :L] = input_ids
        out["input_mask"][row, :L] = 1
        out["lm_label_ids"][row, 1 : L - 1] = token_labels
        out["is_next"][row] = is_next
        out["image_label"][row, :n] = image_label[:n]
        out["image_mask"][row, : n + 1] = 1  # + global row
        out["masked_label"][row] = masked_label[: cfg.region_len]
        # stable digest, not hash(): PYTHONHASHSEED randomizes str hashes
        # per process and this id must be reproducible across runs
        import hashlib

        md5 = hashlib.md5(str(image_id).encode("utf-8")).digest()
        out["image_id"][row] = int.from_bytes(md5[:4], "little") % 2**31
        # note: image_target was written BEFORE random_region — the regression
        # target is the unmasked feature (reference deep-copies pre-masking,
        # concept_cap_dataset.py:456-461)

    def __call__(
        self,
        rf: RegionFeatures,
        caption: str,
        rng: np.random.Generator,
        image_id: str = "",
    ) -> Dict[str, np.ndarray]:
        """Single-sample form (tests/inspection); training uses fill()."""
        out = self.alloc_batch(1)
        self.fill(out, 0, rf, caption, rng, image_id)
        sample = {
            "input_ids": out["input_ids"][0],
            "input_mask": out["input_mask"][0],
            "segment_ids": out["segment_ids"][0],
            "lm_label_ids": out["lm_label_ids"][0],
            "is_next": out["is_next"][0],
            "image_feat": out["image_feat"][0, 1:],
            "image_loc": out["image_loc"][0, 1:],
            "image_target": out["image_target"][0],
            "image_label": out["image_label"][0],
            "image_mask": out["image_mask"][0, 1:],
            "masked_label": out["masked_label"][0],
            "image_id": out["image_id"][0],
        }
        return sample


def finalize_batch(out: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Fill the reserved global-feature row 0 in-place and strip host-only
    fields (reference ConceptCapLoaderTrain.__iter__,
    concept_cap_dataset.py:248-267)."""
    masked_label = out.pop("masked_label")
    count = np.maximum(np.sum(~masked_label, axis=1, keepdims=True), 1)
    out["image_feat"][:, 0] = out["image_feat"][:, 1:].sum(axis=1) / count
    out["image_loc"][:, 0] = np.array([0, 0, 1, 1, 1], np.float32)
    out["image_mask"][:, 0] = 1
    return out


def collate_concap(samples: List[Dict[str, np.ndarray]]) -> Dict[str, np.ndarray]:
    """Stack samples and prepend the global image feature row (reference
    ConceptCapLoaderTrain.__iter__, concept_cap_dataset.py:248-267).

    The global feature is sum(features) / count(regions NOT co-masked via
    masked_label); its location is [0,0,1,1,1] and its mask is 1. After this
    the batch has region_len+1 rows and image_label for the R-1 real rows.
    """
    batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
    masked_label = batch.pop("masked_label")
    sum_count = np.sum(masked_label == 0, axis=1, keepdims=True).astype(np.float32)
    sum_count[sum_count == 0] = 1
    g_feat = batch["image_feat"].sum(axis=1) / sum_count
    b = g_feat.shape[0]
    batch["image_feat"] = np.concatenate(
        [g_feat[:, None, :], batch["image_feat"]], axis=1
    )
    g_loc = np.tile(np.array([[[0, 0, 1, 1, 1]]], np.float32), (b, 1, 1))
    batch["image_loc"] = np.concatenate([g_loc, batch["image_loc"]], axis=1)
    batch["image_mask"] = np.concatenate(
        [np.ones((b, 1), batch["image_mask"].dtype), batch["image_mask"]], axis=1
    )
    return batch


class ConceptCapLoader:
    """Iterable of CC pretraining batches (reference ConceptCapLoaderTrain /
    Val, concept_cap_dataset.py:154-397).

    Multi-host sharding: pass (shard_id, num_shards) to give each host its
    slice of the key list — replaces the reference's per-rank LMDB shard
    convention (concept_cap_dataset.py:198-207).
    """

    def __init__(
        self,
        store: FeatureStore,
        captions: Dict[str, str],
        tokenizer: Tokenizer,
        *,
        batch_size: int = 512,
        cfg: ConceptCapSampleConfig = ConceptCapSampleConfig(),
        shuffle: bool = True,
        seed: int = 0,
        shard_id: int = 0,
        num_shards: int = 1,
        drop_last: bool = True,
        num_workers: int = 0,
    ):
        self.store = store
        self.captions = captions
        self.preprocessor = ConceptCapPreprocessor(
            tokenizer, list(captions.values()), cfg
        )
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        keys = [k for k in store.keys() if k in captions]
        self.keys = keys[shard_id::num_shards]
        self.drop_last = drop_last
        self.epoch = 0
        #: >1 enables the thread-pool batch builder (the reference used a
        #: 25-process PrefetchDataZMQ fleet, concept_cap_dataset.py:233);
        #: samples are seeded by (seed, epoch, key index) so the parallel
        #: stream is bit-identical to the serial one
        self.num_workers = num_workers

    def __len__(self) -> int:
        if self.drop_last:
            return len(self.keys) // self.batch_size
        return (len(self.keys) + self.batch_size - 1) // self.batch_size

    def _epoch_slices(self, epoch: int) -> List[np.ndarray]:
        order = np.arange(len(self.keys))
        if self.shuffle:
            np.random.default_rng((self.seed, epoch)).shuffle(order)
        B = self.batch_size
        n_full = len(order) // B
        slices = [order[i * B : (i + 1) * B] for i in range(n_full)]
        if not self.drop_last and len(order) % B:
            slices.append(order[n_full * B :])
        return slices

    def _build_batch(self, idx_slice: np.ndarray, epoch: int) -> Dict[str, np.ndarray]:
        # samples are written straight into preallocated batch buffers —
        # no per-sample arrays, no stack/concat pass (the profile showed
        # those dominating the 1-core pipeline)
        out = self.preprocessor.alloc_batch(len(idx_slice))
        for row, idx in enumerate(idx_slice):
            key = self.keys[idx]
            rng = np.random.default_rng((self.seed, epoch, int(idx)))
            self.preprocessor.fill(
                out, row, self.store.get(key), self.captions[key], rng,
                image_id=key,
            )
        return finalize_batch(out)

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        # epoch advances at iteration START (a partially-consumed epoch
        # still counts — generator exhaustion is not guaranteed, e.g. zip)
        epoch, self.epoch = self.epoch, self.epoch + 1
        slices = self._epoch_slices(epoch)
        if self.num_workers > 1:
            yield from self._iter_parallel(slices, epoch)
        else:
            for s in slices:
                yield self._build_batch(s, epoch)

    def _iter_parallel(self, slices, epoch: int) -> Iterator[Dict[str, np.ndarray]]:
        """Thread-pool batch building, yielded strictly in order.

        Threads (not processes): the numpy region kernels release the GIL
        and the feature store is mmap'd, so on multi-core hosts the builders
        overlap — the GIL-held span (pure-Python tokenize/mask bookkeeping)
        measures only ~6% of a batch build (scripts/loader_scaling.py), a
        ~17x thread-scaling ceiling. Determinism is preserved because every
        sample's RNG is derived from its key index, not its arrival order."""
        import itertools
        from collections import deque
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=self.num_workers) as ex:
            it = iter(slices)
            pending: deque = deque()
            for s in itertools.islice(it, self.num_workers + 2):
                pending.append(ex.submit(self._build_batch, s, epoch))
            while pending:
                batch = pending.popleft().result()
                nxt = next(it, None)
                if nxt is not None:
                    pending.append(ex.submit(self._build_batch, nxt, epoch))
                yield batch
