"""The port's binding of the native VFR reader (``data/native_vfs.py``).

The library is built from the checkout's ``native/vfs/vfs.cc`` into
``build/native_vfs/`` (here into a fresh directory, so that the build runs)
with nothing written under ``native/``; its reads equal the port's Python
``VrfFeatureStore``'s (and the records they were written from), with and
without targets; a source that does not compile raises, and
``native_available`` then says so.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(shutil.which("g++") is None and shutil.which("c++") is None,
                                reason="no C++ compiler")


def _snapshot(root: Path) -> dict:
    return {str(p.relative_to(root)): (p.stat().st_size, p.stat().st_mtime_ns)
            for p in sorted(root.rglob("*"))}


@pytest.fixture()
def fresh_build(tmp_path, monkeypatch):
    from vilbert_tpu_torch.data import native_vfs

    monkeypatch.setattr(native_vfs, "BUILD_DIR", tmp_path / "build" / "native_vfs")
    native_vfs.load_library.cache_clear()
    yield native_vfs
    native_vfs.load_library.cache_clear()


def _write(path, store, feature_dim, target_dim):
    from vilbert_tpu_torch.data.feature_store import VrfWriter

    with VrfWriter(str(path), feature_dim=feature_dim, target_dim=target_dim) as w:
        for k in store.keys():
            w.add(k, store.get(k))


def test_builds_into_build_and_leaves_native_untouched(fresh_build, tmp_path):
    before = _snapshot(REPO / "native")
    assert fresh_build.native_available()
    lib = fresh_build.library_path()
    assert lib.exists() and lib.parent == tmp_path / "build" / "native_vfs"
    assert _snapshot(REPO / "native") == before


def test_native_matches_python(fresh_build, tmp_path):
    from vilbert_tpu_torch.data.feature_store import (
        InMemoryFeatureStore,
        RegionFeatures,
        VrfFeatureStore,
    )

    store = InMemoryFeatureStore.synthetic(num_images=5, num_boxes=9, feature_dim=16,
                                           target_dim=7)
    path = tmp_path / "n.vfr"
    _write(path, store, 16, 7)
    ns, py = fresh_build.NativeVrfFeatureStore(str(path)), VrfFeatureStore(str(path))
    assert sorted(ns.keys()) == sorted(py.keys()) == sorted(store.keys())
    assert ns.feature_dim == 16 and ns.target_dim == 7
    for k in store.keys():
        a, b, c = py.get(k), ns.get(k), store.get(k)
        assert isinstance(b, RegionFeatures)
        for x in (a, c):
            np.testing.assert_array_equal(x.features, b.features)
            np.testing.assert_array_equal(x.boxes, b.boxes)
            np.testing.assert_array_equal(x.target, b.target)
            assert (x.image_h, x.image_w) == (b.image_h, b.image_w)
    ns.prefetch(store.keys())
    with pytest.raises(KeyError):
        ns.get("nope")
    ns.close()


def test_native_no_target(fresh_build, tmp_path):
    from vilbert_tpu_torch.data.feature_store import InMemoryFeatureStore, VrfFeatureStore

    store = InMemoryFeatureStore.synthetic(num_images=3, num_boxes=4, feature_dim=8,
                                           target_dim=None)
    path = tmp_path / "nt.vfr"
    _write(path, store, 8, 5)
    ns = fresh_build.NativeVrfFeatureStore(str(path))
    rf = ns.get("0")
    assert rf.target is None and VrfFeatureStore(str(path)).get("0").target is None
    np.testing.assert_array_equal(rf.features, store.get("0").features)
    ns.close()


def test_a_failed_build_raises(fresh_build, tmp_path, monkeypatch):
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(fresh_build, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="native VFR reader failed"):
        fresh_build.load_library()
    assert not fresh_build.native_available()
    with pytest.raises(RuntimeError):
        fresh_build.NativeVrfFeatureStore(str(tmp_path / "x.vfr"))
