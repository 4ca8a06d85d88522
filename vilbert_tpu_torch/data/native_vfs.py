"""ctypes binding of the native VFR reader (``native/vfs/vfs.cc``).

Counterpart of ``vilbert_tpu/data/native_vfs.py``: ``NativeVrfFeatureStore``
is a FeatureStore over the C++ mmap reader with a background prefetch pool,
giving what the Python ``VrfFeatureStore`` gives, as the port's own
``RegionFeatures``. The library is built from the checkout's
``native/vfs/vfs.cc`` with the Makefile's flags into ``build/native_vfs/``
at the root of the checkout (named by a hash of the source and flags), at
first use; nothing is written under ``native/``. A failed build raises;
``native_available`` says whether the library built.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

import numpy as np

from vilbert_tpu_torch.data.feature_store import RegionFeatures

REPO_DIR = Path(__file__).resolve().parents[2]
SOURCE = REPO_DIR / "native" / "vfs" / "vfs.cc"
BUILD_DIR = REPO_DIR / "build" / "native_vfs"
#: native/vfs/Makefile's CXXFLAGS and link flag
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread", "-shared")


class _VfsRecord(ctypes.Structure):
    _fields_ = [
        ("num_boxes", ctypes.c_uint32),
        ("image_h", ctypes.c_uint32),
        ("image_w", ctypes.c_uint32),
        ("has_target", ctypes.c_uint8),
        ("features", ctypes.POINTER(ctypes.c_float)),
        ("boxes", ctypes.POINTER(ctypes.c_float)),
        ("target", ctypes.POINTER(ctypes.c_float)),
    ]


def library_path() -> Path:
    """Where the library of the current source and flags lives."""
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvfs_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``vfs.cc`` unless a library of the same source exists; raises
    with the compiler's output if it fails."""
    lib = library_path()
    if lib.exists():
        return lib
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler (g++, c++ or $CXX) to build the native VFR reader")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building the native VFR reader failed ({proc.returncode}):\n"
                f"{' '.join(cmd)}\n{proc.stdout}")
        os.replace(tmp, lib)  # atomic: a concurrent build sees all or nothing
    finally:
        tmp.unlink(missing_ok=True)
    return lib


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the reader's library, once per process."""
    lib = ctypes.CDLL(str(build()))
    lib.vfs_open.restype = ctypes.c_void_p
    lib.vfs_open.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.vfs_close.argtypes = [ctypes.c_void_p]
    lib.vfs_num_records.restype = ctypes.c_uint64
    lib.vfs_num_records.argtypes = [ctypes.c_void_p]
    lib.vfs_feature_dim.restype = ctypes.c_uint64
    lib.vfs_feature_dim.argtypes = [ctypes.c_void_p]
    lib.vfs_target_dim.restype = ctypes.c_uint64
    lib.vfs_target_dim.argtypes = [ctypes.c_void_p]
    lib.vfs_keys.restype = ctypes.POINTER(ctypes.c_char_p)
    lib.vfs_keys.argtypes = [ctypes.c_void_p]
    lib.vfs_get.restype = ctypes.c_int
    lib.vfs_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.POINTER(_VfsRecord)]
    lib.vfs_prefetch.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p), ctypes.c_int]
    return lib


def native_available() -> bool:
    """Whether the library builds and loads here."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


class NativeVrfFeatureStore:
    """FeatureStore over the C++ reader; zero-copy numpy views into the mmap."""

    def __init__(self, path: str, prefetch_threads: int = 2):
        lib = load_library()
        self._lib = lib
        self._handle = lib.vfs_open(path.encode(), prefetch_threads)
        if not self._handle:
            raise IOError(f"failed to open VFR file {path}")
        self.feature_dim = int(lib.vfs_feature_dim(self._handle))
        self.target_dim = int(lib.vfs_target_dim(self._handle))
        n = int(lib.vfs_num_records(self._handle))
        key_arr = lib.vfs_keys(self._handle)
        self._keys = [key_arr[i].decode() for i in range(n)]

    def get(self, image_id: str) -> RegionFeatures:
        rec = _VfsRecord()
        rc = self._lib.vfs_get(self._handle, str(image_id).encode(), ctypes.byref(rec))
        if rc != 0:
            raise KeyError(image_id)
        n = rec.num_boxes
        feats = np.ctypeslib.as_array(rec.features, (n, self.feature_dim))
        boxes = np.ctypeslib.as_array(rec.boxes, (n, 4))
        target = None
        if rec.has_target:
            target = np.ctypeslib.as_array(rec.target, (n, self.target_dim))
        return RegionFeatures(feats, boxes, int(rec.image_h), int(rec.image_w), target)

    def prefetch(self, keys: Sequence[str]) -> None:
        arr = (ctypes.c_char_p * len(keys))(*[str(k).encode() for k in keys])
        self._lib.vfs_prefetch(self._handle, arr, len(keys))

    def keys(self) -> List[str]:
        return list(self._keys)

    def close(self) -> None:
        if self._handle:
            self._lib.vfs_close(self._handle)
            self._handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
