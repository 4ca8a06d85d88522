"""Pure-Python read-only LMDB + minimal writer.

The port's own copy of ``vilbert_tpu/data/lmdb_reader.py``: the port imports
nothing of the JAX package, and ``tests/test_torch_host.py`` holds the
copy to the original.

The reference stores every region-feature artifact in LMDB via the C lmdb
library (vilbert/datasets/_image_features_reader.py:49-90,
script/convert_to_lmdb.py:29-48). That package is not always available on
TPU hosts; this module implements the on-disk format directly so published
artifacts can be ingested with zero native dependencies:

- ``LmdbReader``: mmap-backed read-only B-tree walk of an LMDB environment
  (get by key, full in-order iteration). Handles branch/leaf pages and
  F_BIGDATA overflow values — everything the reference artifacts use (one
  unnamed database, no DUPSORT).
- ``LmdbWriter``: minimal single-transaction writer producing a valid LMDB
  file (sorted keys, depth ≤ 3 B-tree, overflow pages, double meta page).
  Used to build test fixtures and by tools that re-export to the reference
  format.

Format layout follows upstream lmdb mdb.c (MDB_page / MDB_node / MDB_meta
structs, 64-bit build, page size 4096).
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Dict, Iterator, List, Optional, Tuple

PAGE_SIZE = 4096
_MAGIC = 0xBEEFC0DE
_VERSION = 1

# page flags
P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_INVALID = 0xFFFFFFFFFFFFFFFF

# node flags
F_BIGDATA = 0x01

_PAGE_HDR = struct.Struct("<QHHHH")      # pgno, pad, flags, lower, upper
_PAGE_HDR_OVF = struct.Struct("<QHHI")   # pgno, pad, flags, pb_pages
_NODE_HDR = struct.Struct("<HHHH")       # lo, hi, flags, ksize
# MDB_db: pad(u32) flags(u16) depth(u16) branch(u64) leaf(u64) ovf(u64)
#         entries(u64) root(u64)
_DB = struct.Struct("<IHHQQQQQ")
_META_HEAD = struct.Struct("<IIQQ")      # magic, version, address, mapsize


def _env_file(path: str) -> str:
    return os.path.join(path, "data.mdb") if os.path.isdir(path) else path


class LmdbReader:
    """Read-only access to one LMDB environment's main (unnamed) database."""

    def __init__(self, path: str):
        self.path = _env_file(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = max(
            (self._read_meta(0), self._read_meta(1)), key=lambda m: m["txnid"]
        )
        self.psize = meta["psize"] or PAGE_SIZE
        self._root = meta["main_root"]
        self.entries = meta["main_entries"]

    # -- meta ---------------------------------------------------------------

    def _read_meta(self, pageno: int) -> Dict:
        base = pageno * PAGE_SIZE  # meta pages are at the default page size
        off = base + 16            # past the page header
        magic, version, _addr, _mapsize = _META_HEAD.unpack_from(self._mm, off)
        if magic != _MAGIC:
            raise ValueError(f"{self.path}: not an LMDB file (bad magic)")
        free_db = _DB.unpack_from(self._mm, off + _META_HEAD.size)
        main_db = _DB.unpack_from(self._mm, off + _META_HEAD.size + _DB.size)
        last_pg, txnid = struct.unpack_from(
            "<QQ", self._mm, off + _META_HEAD.size + 2 * _DB.size
        )
        return {
            "psize": free_db[0],  # mm_psize lives in mm_dbs[FREE_DBI].md_pad
            "main_root": main_db[7],
            "main_entries": main_db[6],
            "txnid": txnid,
            "last_pg": last_pg,
        }

    # -- page access --------------------------------------------------------

    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _page_header(self, pgno: int) -> Tuple[int, int, int]:
        base = self._page(pgno)
        _, _, flags, lower, upper = _PAGE_HDR.unpack_from(self._mm, base)
        return flags, lower, upper

    def _num_keys(self, lower: int) -> int:
        return (lower - 16) // 2

    def _node_off(self, pgno: int, i: int) -> int:
        base = self._page(pgno)
        (ptr,) = struct.unpack_from("<H", self._mm, base + 16 + 2 * i)
        return base + ptr

    def _node(self, pgno: int, i: int) -> Tuple[int, int, int, bytes, int]:
        """(lo, hi, flags, key, data_offset)."""
        off = self._node_off(pgno, i)
        lo, hi, flags, ksize = _NODE_HDR.unpack_from(self._mm, off)
        key = bytes(self._mm[off + 8 : off + 8 + ksize])
        return lo, hi, flags, key, off + 8 + ksize

    def _leaf_value(self, lo: int, hi: int, flags: int, doff: int) -> bytes:
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            (ovf_pgno,) = struct.unpack_from("<Q", self._mm, doff)
            start = self._page(ovf_pgno) + 16
            return bytes(self._mm[start : start + dsize])
        return bytes(self._mm[doff : doff + dsize])

    # -- b-tree -------------------------------------------------------------

    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode()
        if self._root == P_INVALID:
            return None
        pgno = self._root
        while True:
            flags, lower, _ = self._page_header(pgno)
            n = self._num_keys(lower)
            if flags & P_BRANCH:
                # branch node i covers keys >= its key (node 0: -inf)
                lo_i, hi_i = 1, n - 1
                child_i = 0
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    _, _, _, k, _ = self._node(pgno, mid)
                    if k <= key:
                        child_i = mid
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                lo, hi, nflags, _, _ = self._node(pgno, child_i)
                pgno = lo | (hi << 16) | (nflags << 32)
            elif flags & P_LEAF:
                lo_i, hi_i = 0, n - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    lo, hi, nflags, k, doff = self._node(pgno, mid)
                    if k == key:
                        return self._leaf_value(lo, hi, nflags, doff)
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            else:
                raise ValueError(f"unexpected page flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """In-order iteration over (key, value) of the main database."""
        if self._root == P_INVALID:
            return
        yield from self._walk(self._root)

    def _walk(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        flags, lower, _ = self._page_header(pgno)
        n = self._num_keys(lower)
        if flags & P_BRANCH:
            for i in range(n):
                lo, hi, nflags, _, _ = self._node(pgno, i)
                yield from self._walk(lo | (hi << 16) | (nflags << 32))
        elif flags & P_LEAF:
            for i in range(n):
                lo, hi, nflags, k, doff = self._node(pgno, i)
                yield k, self._leaf_value(lo, hi, nflags, doff)

    def keys(self) -> List[bytes]:
        return [k for k, _ in self.items()]

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            pass
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# minimal writer
# ---------------------------------------------------------------------------

#: values larger than this go to overflow pages (real lmdb's node-size limit
#: for a 4K page is ~2024 bytes; being conservative is always format-legal)
_INLINE_MAX = 1024
#: max bytes of nodes+ptrs we pack per page
_PAGE_CAPACITY = PAGE_SIZE - 16


def _node_size(ksize: int, dsize: int) -> int:
    sz = 8 + ksize + dsize
    return sz + (sz & 1)  # 2-byte alignment, as mdb.c rounds


class LmdbWriter:
    """Single-shot sorted bulk writer producing a valid LMDB file.

    Not a general transactional store — it exists so fixtures and
    re-exports in the reference's artifact format can be produced without
    the C library. Compatible with both the C reader and LmdbReader.
    """

    def __init__(self, path: str, subdir: bool = True):
        if subdir:
            os.makedirs(path, exist_ok=True)
            self.path = os.path.join(path, "data.mdb")
        else:
            self.path = path
        self._items: Dict[bytes, bytes] = {}

    def put(self, key, value) -> None:
        if isinstance(key, str):
            key = key.encode()
        if isinstance(value, str):
            value = value.encode()
        self._items[bytes(key)] = bytes(value)

    # -- page builders ------------------------------------------------------

    @staticmethod
    def _build_page(pgno: int, flags: int, nodes: List[bytes]) -> bytes:
        """Pack nodes (already serialized, in key order) into one page."""
        n = len(nodes)
        lower = 16 + 2 * n
        page = bytearray(PAGE_SIZE)
        upper = PAGE_SIZE
        ptrs = []
        for node in reversed(nodes):
            upper -= len(node)
            page[upper : upper + len(node)] = node
            ptrs.append(upper)
        ptrs.reverse()
        _PAGE_HDR.pack_into(page, 0, pgno, 0, flags, lower, upper)
        for i, p in enumerate(ptrs):
            struct.pack_into("<H", page, 16 + 2 * i, p)
        return bytes(page)

    @staticmethod
    def _leaf_node(key: bytes, data: bytes, big_pgno: Optional[int]) -> bytes:
        dsize = len(data)
        if big_pgno is not None:
            body = struct.pack("<Q", big_pgno)
            flags = F_BIGDATA
        else:
            body = data
            flags = 0
        raw = _NODE_HDR.pack(dsize & 0xFFFF, dsize >> 16, flags, len(key)) + key + body
        return raw + b"\x00" * (len(raw) & 1)

    @staticmethod
    def _branch_node(key: bytes, child: int) -> bytes:
        raw = _NODE_HDR.pack(
            child & 0xFFFF, (child >> 16) & 0xFFFF, (child >> 32) & 0xFFFF,
            len(key),
        ) + key
        return raw + b"\x00" * (len(raw) & 1)

    def close(self) -> None:
        items = sorted(self._items.items())
        pages: List[bytes] = [b"", b""]  # meta pages patched at the end
        next_pgno = 2
        ovf_pages = 0

        # 1. overflow chunks for big values
        big: Dict[bytes, int] = {}
        for k, v in items:
            if len(v) > _INLINE_MAX:
                npages = (16 + len(v) + PAGE_SIZE - 1) // PAGE_SIZE
                chunk = bytearray(npages * PAGE_SIZE)
                _PAGE_HDR_OVF.pack_into(chunk, 0, next_pgno, 0, P_OVERFLOW, npages)
                chunk[16 : 16 + len(v)] = v
                # one multi-page element (the page list is only joined at the
                # end, so elements need not be page-sized) — slicing per page
                # dominated flush time on big stores
                pages.append(bytes(chunk))
                big[k] = next_pgno
                next_pgno += npages
                ovf_pages += npages

        # 2. leaves (greedy fill)
        leaves: List[Tuple[bytes, int]] = []  # (first_key, pgno)
        cur_nodes: List[bytes] = []
        cur_first: Optional[bytes] = None
        cur_used = 0

        def flush_leaf():
            nonlocal cur_nodes, cur_first, cur_used, next_pgno
            if not cur_nodes:
                return
            pages.append(self._build_page(next_pgno, P_LEAF, cur_nodes))
            leaves.append((cur_first, next_pgno))
            next_pgno += 1
            cur_nodes, cur_first, cur_used = [], None, 0

        for k, v in items:
            node = self._leaf_node(k, v, big.get(k))
            need = len(node) + 2
            if cur_nodes and cur_used + need > _PAGE_CAPACITY:
                flush_leaf()
            if cur_first is None:
                cur_first = k
            cur_nodes.append(node)
            cur_used += need
        flush_leaf()

        # 3. branch levels until a single root
        depth = 1
        level = leaves
        branch_pages = 0
        while len(level) > 1:
            depth += 1
            nxt: List[Tuple[bytes, int]] = []
            cur_nodes, cur_first, cur_used = [], None, 0
            first_in_page = True

            def flush_branch():
                nonlocal cur_nodes, cur_first, cur_used, next_pgno
                nonlocal first_in_page, branch_pages
                if not cur_nodes:
                    return
                pages.append(self._build_page(next_pgno, P_BRANCH, cur_nodes))
                nxt.append((cur_first, next_pgno))
                next_pgno += 1
                branch_pages += 1
                cur_nodes, cur_first, cur_used = [], None, 0
                first_in_page = True

            for first_key, child in level:
                # the first node of every branch page carries an empty key
                key = b"" if first_in_page else first_key
                node = self._branch_node(key, child)
                need = len(node) + 2
                if cur_nodes and cur_used + need > _PAGE_CAPACITY:
                    flush_branch()
                    key = b""
                    node = self._branch_node(key, child)
                    need = len(node) + 2
                if cur_first is None:
                    cur_first = first_key
                cur_nodes.append(node)
                cur_used += need
                first_in_page = False
            flush_branch()
            level = nxt

        root = level[0][1] if level else P_INVALID
        if not items:
            depth = 0
        last_pg = next_pgno - 1

        # 4. meta pages (identical content; readers pick max txnid)
        def meta_page(pgno: int) -> bytes:
            page = bytearray(PAGE_SIZE)
            _PAGE_HDR.pack_into(page, 0, pgno, 0, P_META, 0, 0)
            off = 16
            _META_HEAD.pack_into(page, off, _MAGIC, _VERSION, 0,
                                 max(next_pgno * PAGE_SIZE, 1 << 20))
            off += _META_HEAD.size
            # free db: psize in md_pad, empty tree
            _DB.pack_into(page, off, PAGE_SIZE, 0, 0, 0, 0, 0, 0, P_INVALID)
            off += _DB.size
            _DB.pack_into(
                page, off, 0, 0, depth, branch_pages, len(leaves), ovf_pages,
                len(items), root,
            )
            off += _DB.size
            struct.pack_into("<QQ", page, off, last_pg, 1)  # last_pg, txnid=1
            return bytes(page)

        pages[0] = meta_page(0)
        pages[1] = meta_page(1)
        with open(self.path, "wb") as f:
            f.write(b"".join(pages))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
