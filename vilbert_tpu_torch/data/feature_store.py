"""Region-feature stores.

The port's own copy of ``vilbert_tpu/data/feature_store.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

The reference reads Faster-R-CNN region features from LMDB through the C
lmdb library (vilbert/datasets/_image_features_reader.py:17-178). This module
provides the same capability with a TPU-host-friendly design:

- ``VrfFeatureStore``: our native mmap-able record format ("VFR") with an
  msgpack index — zero-copy numpy views over one flat file, no per-item
  pickle decode. A C++ reader with background prefetch lives in
  ``native/vfs`` (optional fast path; this Python reader is the portable
  fallback and produces identical results).
- ``InMemoryFeatureStore``: dict-backed store for tests and demos.
- ``LmdbFeatureStore``: reads the reference's actual LMDB artifacts when the
  ``lmdb`` package is available (gated import) for drop-in parity.
- ``read_with_global``: reproduces the reference reader's output contract —
  mean "global" feature row 0, normalized [N+1,5] locations with a
  [0,0,1,1,1] global row, pixel-coordinate variant
  (_image_features_reader.py:93-131).
"""

from __future__ import annotations

import io
import mmap
import os
import struct
from typing import Dict, List, NamedTuple, Optional, Protocol, Tuple

import numpy as np

from vilbert_tpu_torch.data.boxes import normalize_locations

FEATURE_DIM = 2048
TARGET_DIM = 1601


class RegionFeatures(NamedTuple):
    features: np.ndarray          # [N, feature_dim] fp32
    boxes: np.ndarray             # [N, 4] pixel xyxy fp32
    image_h: int
    image_w: int
    target: Optional[np.ndarray] = None  # [N, target_dim] soft class dist


class FeatureStore(Protocol):
    def get(self, image_id: str) -> RegionFeatures: ...
    def keys(self) -> List[str]: ...


class ReaderOutput(NamedTuple):
    features: np.ndarray       # [N+1, D] with mean global row 0
    num_boxes: int             # N+1
    locations: np.ndarray      # [N+1, 5] normalized, global [0,0,1,1,1]
    locations_ori: np.ndarray  # [N+1, 5] pixel coords, global [0,0,w,h,w*h]


def read_with_global(rf: RegionFeatures) -> ReaderOutput:
    """Reference reader semantics (_image_features_reader.py:93-131)."""
    n = rf.features.shape[0]
    g_feat = rf.features.sum(axis=0, dtype=np.float64) / n
    features = np.concatenate(
        [g_feat[None].astype(np.float32), rf.features], axis=0
    )
    loc = normalize_locations(rf.boxes, rf.image_w, rf.image_h)
    loc_ori = np.zeros((n, 5), np.float32)
    loc_ori[:, :4] = rf.boxes
    loc_ori[:, 4] = (rf.boxes[:, 3] - rf.boxes[:, 1]) * (
        rf.boxes[:, 2] - rf.boxes[:, 0]
    )
    g_loc = np.array([[0, 0, 1, 1, 1]], np.float32)
    g_loc_ori = np.array(
        [[0, 0, rf.image_w, rf.image_h, rf.image_w * rf.image_h]], np.float32
    )
    return ReaderOutput(
        features=features,
        num_boxes=n + 1,
        locations=np.concatenate([g_loc, loc], axis=0),
        locations_ori=np.concatenate([g_loc_ori, loc_ori], axis=0),
    )


class InMemoryFeatureStore:
    """Test/demo store over a dict of RegionFeatures."""

    def __init__(self, items: Dict[str, RegionFeatures]):
        self._items = {str(k): v for k, v in items.items()}

    def get(self, image_id: str) -> RegionFeatures:
        return self._items[str(image_id)]

    def keys(self) -> List[str]:
        return list(self._items)

    @classmethod
    def synthetic(
        cls,
        num_images: int = 32,
        num_boxes: int = 36,
        feature_dim: int = FEATURE_DIM,
        target_dim: Optional[int] = TARGET_DIM,
        seed: int = 0,
    ) -> "InMemoryFeatureStore":
        rng = np.random.RandomState(seed)
        items = {}
        for i in range(num_images):
            w, h = 640, 480
            x1 = rng.uniform(0, w / 2, num_boxes)
            y1 = rng.uniform(0, h / 2, num_boxes)
            boxes = np.stack(
                [x1, y1, x1 + rng.uniform(32, w / 2, num_boxes),
                 y1 + rng.uniform(32, h / 2, num_boxes)], axis=1
            ).astype(np.float32)
            target = None
            if target_dim:
                target = rng.rand(num_boxes, target_dim).astype(np.float32)
                target /= target.sum(-1, keepdims=True)
            items[str(i)] = RegionFeatures(
                features=rng.randn(num_boxes, feature_dim).astype(np.float32),
                boxes=boxes,
                image_h=h,
                image_w=w,
                target=target,
            )
        return cls(items)


# ---------------------------------------------------------------------------
# VFR: mmap-able flat record format
# ---------------------------------------------------------------------------

_MAGIC = b"VFR1"
_HEADER = struct.Struct("<4sQQ")  # magic, index_offset, num_records
_REC_HEADER = struct.Struct("<IIIB")  # num_boxes, image_h, image_w, has_target


class VrfWriter:
    """Stream records into a .vfr file (single pass, index at the end)."""

    def __init__(self, path: str, feature_dim: int = FEATURE_DIM,
                 target_dim: int = TARGET_DIM):
        self._f = open(path, "wb")
        self._f.write(_HEADER.pack(_MAGIC, 0, 0))
        self._index: Dict[str, int] = {}
        self.feature_dim = feature_dim
        self.target_dim = target_dim

    def add(self, image_id: str, rf: RegionFeatures) -> None:
        assert str(image_id) not in self._index, f"duplicate key {image_id}"
        self._index[str(image_id)] = self._f.tell()
        n = rf.features.shape[0]
        assert rf.features.shape == (n, self.feature_dim)
        assert rf.boxes.shape == (n, 4)
        has_target = rf.target is not None
        self._f.write(_REC_HEADER.pack(n, rf.image_h, rf.image_w, int(has_target)))
        self._f.write(np.ascontiguousarray(rf.features, np.float32).tobytes())
        self._f.write(np.ascontiguousarray(rf.boxes, np.float32).tobytes())
        if has_target:
            assert rf.target.shape == (n, self.target_dim)
            self._f.write(np.ascontiguousarray(rf.target, np.float32).tobytes())

    def close(self) -> None:
        import msgpack

        index_offset = self._f.tell()
        meta = {
            "index": self._index,
            "feature_dim": self.feature_dim,
            "target_dim": self.target_dim,
        }
        self._f.write(msgpack.packb(meta))
        self._f.seek(0)
        self._f.write(_HEADER.pack(_MAGIC, index_offset, len(self._index)))
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class VrfFeatureStore:
    """mmap-backed reader for .vfr files — zero-copy numpy views."""

    def __init__(self, path: str):
        import msgpack

        self._file = open(path, "rb")
        self._mm = mmap.mmap(self._file.fileno(), 0, access=mmap.ACCESS_READ)
        magic, index_offset, num_records = _HEADER.unpack_from(self._mm, 0)
        assert magic == _MAGIC, f"not a VFR file: {path}"
        meta = msgpack.unpackb(self._mm[index_offset:])
        self._index: Dict[str, int] = meta["index"]
        self.feature_dim = meta["feature_dim"]
        self.target_dim = meta["target_dim"]

    def get(self, image_id: str) -> RegionFeatures:
        off = self._index[str(image_id)]
        n, h, w, has_target = _REC_HEADER.unpack_from(self._mm, off)
        off += _REC_HEADER.size
        feats = np.frombuffer(
            self._mm, np.float32, n * self.feature_dim, off
        ).reshape(n, self.feature_dim)
        off += feats.nbytes
        boxes = np.frombuffer(self._mm, np.float32, n * 4, off).reshape(n, 4)
        off += boxes.nbytes
        target = None
        if has_target:
            target = np.frombuffer(
                self._mm, np.float32, n * self.target_dim, off
            ).reshape(n, self.target_dim)
        return RegionFeatures(feats, boxes, h, w, target)

    def keys(self) -> List[str]:
        return list(self._index)

    def close(self) -> None:
        # returned arrays are zero-copy views into the mmap; the mapping can
        # only be dropped once no views remain alive
        try:
            self._mm.close()
        except BufferError:
            pass
        self._file.close()


class LmdbFeatureStore:
    """Reads the reference's LMDB artifacts.

    Value schema per the reference converter (script/convert_to_lmdb.py:36-48):
    pickled {image_id, image_h, image_w, num_boxes, boxes, features}.

    Uses the C ``lmdb`` package when installed; otherwise falls back to the
    first-party pure-Python reader (``data/lmdb_reader.py``) — published
    reference artifacts stay ingestible with zero native dependencies.
    """

    def __init__(self, path: str):
        import pickle

        self._pickle = pickle
        try:
            import lmdb

            self._env = lmdb.open(
                path, max_readers=1, readonly=True, lock=False,
                readahead=False, meminit=False,
            )
            self._get_raw = self._get_raw_clmdb
        except ImportError:
            from vilbert_tpu_torch.data.lmdb_reader import LmdbReader

            self._env = LmdbReader(path)
            self._get_raw = self._env.get
        keys_blob = self._get_raw(b"keys")
        if keys_blob is not None:
            self._keys = [
                k.decode() if isinstance(k, bytes) else str(k)
                for k in self._pickle.loads(keys_blob)
            ]
        else:
            # shard without a "keys" index (reference CC shards iterate the
            # env directly): enumerate the database
            self._keys = [
                k.decode() for k, _ in self._iter_raw() if k != b"keys"
            ]

    def _get_raw_clmdb(self, key: bytes):
        with self._env.begin(write=False) as txn:
            return txn.get(key)

    def _iter_raw(self):
        if hasattr(self._env, "items"):  # pure-python reader
            yield from self._env.items()
        else:
            with self._env.begin(write=False) as txn:
                yield from txn.cursor()

    def get(self, image_id: str) -> RegionFeatures:
        blob = self._get_raw(str(image_id).encode())
        if blob is None:
            raise KeyError(image_id)
        item = self._pickle.loads(blob)
        feats = np.asarray(item["features"], np.float32).reshape(-1, FEATURE_DIM)
        boxes = np.asarray(item["boxes"], np.float32).reshape(-1, 4)
        return RegionFeatures(
            feats, boxes, int(item["image_h"]), int(item["image_w"]),
            item.get("cls_prob"),
        )

    def keys(self) -> List[str]:
        return self._keys


def open_feature_store(path: str) -> FeatureStore:
    """Open by extension: .vfr → VrfFeatureStore, .lmdb dir → LmdbFeatureStore."""
    if path.endswith(".vfr"):
        return VrfFeatureStore(path)
    if path.endswith(".lmdb") or os.path.isdir(path):
        return LmdbFeatureStore(path)
    raise ValueError(f"unknown feature store format: {path}")
