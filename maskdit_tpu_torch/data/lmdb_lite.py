"""lmdb_lite: dependency-free reader/writer for the LMDB on-disk format.

The port's own copy of maskdit_tpu/data/lmdb_lite.py (the port imports
nothing of the JAX package): the same code, so the same puts give the same
bytes. The reference stores latent datasets in LMDB environments
(reference: train_utils/datasets.py:240-304, extract_latent.py:58-108) via
the `lmdb` C binding; this module implements the LMDB v0.9 data format
(MDB_DATA_VERSION=1) directly:

  * ``Reader``: mmap-backed read-only B-tree lookups + ordered iteration
    over a standard ``data.mdb`` — real datasets produced by the reference
    pipeline load unchanged.
  * ``Writer``: single-transaction bulk writer that builds the B-tree
    bottom-up from sorted records and emits a spec-compliant file readable
    by the canonical liblmdb.

A C++ mmap reader with the same layout lives in data/csrc/lmdb_lite.cc;
data/native_io.py builds and binds it. This file is the format's ground
truth, and the reader a caller gets only by asking for it
(``open_reader(path, native=False)``).

Format notes (64-bit little-endian, the only variant the reference uses):
  page header: pgno u64 | pad u16 | flags u16 | lower u16 | upper u16
  meta page  : header + magic u32, version u32, address u64, mapsize u64,
               dbs[2] (pad u32, flags u16, depth u16, branch u64, leaf u64,
               overflow u64, entries u64, root u64), last_pg u64, txnid u64
  node       : lo u16 | hi u16 | flags u16 | ksize u16 | key | data
  branch pgno = lo | hi<<16 | flags<<32; leaf datasize = lo | hi<<16
  psize lives in dbs[0].pad; env flags in dbs[0].flags.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Optional

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01

PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")  # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")  # pad, flags, depth, branch, leaf, ovf, entries, root
_PAGEHDR = struct.Struct("<QHHHH")  # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<HHHH")  # lo, hi, flags, ksize


def _data_path(path: str) -> str:
    """Accept either an environment directory or a data.mdb file path."""
    if os.path.isdir(path):
        return os.path.join(path, "data.mdb")
    return path


class Reader:
    """Read-only LMDB environment (main DB only, no DUPSORT).

    Equivalent surface to the reference's
    ``lmdb.open(path, readonly=True, lock=False).begin().get(key)``.
    """

    kind = "python"

    def __init__(self, path: str):
        self.path = _data_path(path)
        self._f = open(self.path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta = self._pick_meta()
        (self.psize, self._db_flags, self.depth, _, _, _,
         self.entries, self.root) = meta

    def _read_meta(self, pgno: int):
        off = pgno * 4096  # meta pages are always in the first two 4K slots
        hdr = _PAGEHDR.unpack_from(self._mm, off)
        if not hdr[2] & P_META:
            return None
        magic, version, _, _ = _META.unpack_from(self._mm, off + PAGEHDRSZ)
        if magic != MDB_MAGIC or version != MDB_DATA_VERSION:
            return None
        base = off + PAGEHDRSZ + _META.size
        db0 = _DB.unpack_from(self._mm, base)
        db1 = _DB.unpack_from(self._mm, base + _DB.size)
        last_pg, txnid = struct.unpack_from("<QQ", self._mm, base + 2 * _DB.size)
        psize = db0[0]
        return txnid, (psize, db1[1], db1[2], db1[3], db1[4], db1[5], db1[6], db1[7])

    def _pick_meta(self):
        metas = [m for m in (self._read_meta(0), self._read_meta(1)) if m]
        if not metas:
            raise IOError(f"{self.path}: not an LMDB data file")
        return max(metas, key=lambda m: m[0])[1]

    # -- page access --------------------------------------------------------
    def _page(self, pgno: int) -> int:
        return pgno * self.psize

    def _nodes(self, off: int) -> list[int]:
        _, _, flags, lower, _ = _PAGEHDR.unpack_from(self._mm, off)
        n = (lower - PAGEHDRSZ) >> 1
        return [
            off + struct.unpack_from("<H", self._mm, off + PAGEHDRSZ + 2 * i)[0]
            for i in range(n)
        ]

    def _node_key(self, noff: int) -> bytes:
        _, _, _, ksize = _NODEHDR.unpack_from(self._mm, noff)
        return bytes(self._mm[noff + 8 : noff + 8 + ksize])

    def _leaf_value(self, noff: int) -> bytes:
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._mm, noff)
        dsize = lo | (hi << 16)
        if flags & F_BIGDATA:
            (ovf_pgno,) = struct.unpack_from("<Q", self._mm, noff + 8 + ksize)
            start = self._page(ovf_pgno) + PAGEHDRSZ
            return bytes(self._mm[start : start + dsize])
        start = noff + 8 + ksize
        return bytes(self._mm[start : start + dsize])

    def _branch_pgno(self, noff: int) -> int:
        lo, hi, flags, _ = _NODEHDR.unpack_from(self._mm, noff)
        return lo | (hi << 16) | (flags << 32)

    # -- lookups ------------------------------------------------------------
    def get(self, key: bytes) -> Optional[bytes]:
        if isinstance(key, str):
            key = key.encode("utf-8")
        if self.root == P_INVALID:
            return None
        pgno = self.root
        for _ in range(self.depth):
            off = self._page(pgno)
            _, _, flags, _, _ = _PAGEHDR.unpack_from(self._mm, off)
            nodes = self._nodes(off)
            if flags & P_LEAF:
                lo_i, hi_i = 0, len(nodes) - 1
                while lo_i <= hi_i:
                    mid = (lo_i + hi_i) // 2
                    k = self._node_key(nodes[mid])
                    if k == key:
                        return self._leaf_value(nodes[mid])
                    if k < key:
                        lo_i = mid + 1
                    else:
                        hi_i = mid - 1
                return None
            # branch: rightmost child whose key <= target (node 0 = -inf)
            lo_i, hi_i, pick = 1, len(nodes) - 1, 0
            while lo_i <= hi_i:
                mid = (lo_i + hi_i) // 2
                if self._node_key(nodes[mid]) <= key:
                    pick = mid
                    lo_i = mid + 1
                else:
                    hi_i = mid - 1
            pgno = self._branch_pgno(nodes[pick])
        return None

    def items(self) -> Iterator[tuple[bytes, bytes]]:
        """Ordered iteration over all (key, value) pairs."""
        if self.root == P_INVALID:
            return
        yield from self._iter_page(self.root)

    def _iter_page(self, pgno: int) -> Iterator[tuple[bytes, bytes]]:
        off = self._page(pgno)
        _, _, flags, _, _ = _PAGEHDR.unpack_from(self._mm, off)
        nodes = self._nodes(off)
        if flags & P_LEAF:
            for noff in nodes:
                yield self._node_key(noff), self._leaf_value(noff)
        else:
            for noff in nodes:
                yield from self._iter_page(self._branch_pgno(noff))

    def __len__(self) -> int:
        return self.entries

    def close(self) -> None:
        if self._mm is not None:
            self._mm.close()
            self._f.close()
            self._mm = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Writer:
    """Bulk single-transaction LMDB writer.

    Collect records with put(); commit() sorts by key (memcmp order) and
    writes the whole B-tree bottom-up. Replaces the reference's use of the
    lmdb C binding in extract_latent.py:58-108 / datasets.py:79-86.
    """

    NODEMAX = 2034  # (psize - 32) / 2 for psize 4096, matching liblmdb

    def __init__(self, path: str, psize: int = 4096, subdir: bool = True):
        if subdir:
            os.makedirs(path, exist_ok=True)
            self.path = os.path.join(path, "data.mdb")
        else:
            self.path = path
        self.psize = psize
        self._records: dict[bytes, bytes] = {}

    def put(self, key: bytes | str, value: bytes) -> None:
        if isinstance(key, str):
            key = key.encode("utf-8")
        if isinstance(value, str):
            value = value.encode("utf-8")
        if len(key) == 0 or len(key) > 511:
            raise ValueError(f"key size {len(key)} out of range (1..511)")
        self._records[bytes(key)] = bytes(value)

    # -- page builders ------------------------------------------------------
    def _page_hdr(self, pgno: int, flags: int, lower: int, upper: int) -> bytes:
        return _PAGEHDR.pack(pgno, 0, flags, lower, upper)

    def _ovf_hdr(self, pgno: int, npages: int) -> bytes:
        # overflow pages store the page count in the lower/upper slot (u32)
        return struct.pack("<QHHI", pgno, 0, P_OVERFLOW, npages)

    def _build_page(self, pgno: int, flags: int, nodes: list[bytes]) -> bytes:
        ptrs, blob_parts = [], []
        upper = self.psize
        for node in nodes:
            upper -= len(node)
            ptrs.append(upper)
        lower = PAGEHDRSZ + 2 * len(nodes)
        assert lower <= min(ptrs), "page overflow"
        page = bytearray(self.psize)
        page[:PAGEHDRSZ] = self._page_hdr(pgno, flags, lower, upper)
        struct.pack_into(f"<{len(ptrs)}H", page, PAGEHDRSZ, *ptrs)
        # nodes are laid out from the top of the page downward, in order
        for off, node in zip(ptrs, nodes):
            page[off : off + len(node)] = node
        return bytes(page)

    @staticmethod
    def _leaf_node(key: bytes, value: bytes, bigdata_pgno: Optional[int]) -> bytes:
        dsize = len(value)
        if bigdata_pgno is not None:
            body = struct.pack("<Q", bigdata_pgno)
            flags = F_BIGDATA
        else:
            body = value
            flags = 0
        node = _NODEHDR.pack(dsize & 0xFFFF, dsize >> 16, flags, len(key)) + key + body
        return node + b"\x00" * (len(node) & 1)  # 2-byte align

    @staticmethod
    def _branch_node(key: bytes, pgno: int) -> bytes:
        node = _NODEHDR.pack(
            pgno & 0xFFFF, (pgno >> 16) & 0xFFFF, (pgno >> 32) & 0xFFFF, len(key)
        ) + key
        return node + b"\x00" * (len(node) & 1)

    def commit(self) -> None:
        records = sorted(self._records.items())
        psize = self.psize
        next_pg = 2  # 0/1 are metas
        pages: list[tuple[int, bytes]] = []  # (pgno, raw) in write order
        n_leaf = n_branch = n_ovf = 0

        with open(self.path, "wb") as f:
            f.truncate(0)

            def emit(pgno: int, raw: bytes) -> None:
                f.seek(pgno * psize)
                f.write(raw)

            # ---- leaves (+ overflow chains) -------------------------------
            level: list[tuple[bytes, int]] = []  # (first_key, pgno)
            cur_nodes: list[bytes] = []
            cur_first: Optional[bytes] = None
            cur_size = PAGEHDRSZ

            def flush_leaf():
                nonlocal cur_nodes, cur_first, cur_size, next_pg, n_leaf
                if not cur_nodes:
                    return
                pgno = next_pg
                next_pg += 1
                emit(pgno, self._build_page(pgno, P_LEAF, cur_nodes))
                level.append((cur_first, pgno))
                n_leaf += 1
                cur_nodes, cur_first, cur_size = [], None, PAGEHDRSZ

            for key, value in records:
                if 8 + len(key) + len(value) > self.NODEMAX:
                    npages = (PAGEHDRSZ + len(value) + psize - 1) // psize
                    ovf_pgno = next_pg
                    next_pg += npages
                    n_ovf += npages
                    raw = self._ovf_hdr(ovf_pgno, npages) + value
                    emit(ovf_pgno, raw + b"\x00" * (npages * psize - len(raw)))
                    node = self._leaf_node(key, value, ovf_pgno)
                else:
                    node = self._leaf_node(key, value, None)
                need = 2 + len(node)
                if cur_size + need > psize:
                    flush_leaf()
                if cur_first is None:
                    cur_first = key
                cur_nodes.append(node)
                cur_size += need
            flush_leaf()

            # ---- branches, bottom-up -------------------------------------
            depth = 1 if level else 0
            while len(level) > 1:
                depth += 1
                parent: list[tuple[bytes, int]] = []
                cur_nodes, cur_first, cur_size = [], None, PAGEHDRSZ

                def flush_branch():
                    nonlocal cur_nodes, cur_first, cur_size, next_pg, n_branch
                    if not cur_nodes:
                        return
                    pgno = next_pg
                    next_pg += 1
                    emit(pgno, self._build_page(pgno, P_BRANCH, cur_nodes))
                    parent.append((cur_first, pgno))
                    n_branch += 1
                    cur_nodes, cur_first, cur_size = [], None, PAGEHDRSZ

                for i, (first_key, child) in enumerate(level):
                    # node 0 of each branch page carries an empty key
                    key = b"" if not cur_nodes else first_key
                    node = self._branch_node(key, child)
                    need = 2 + len(node)
                    if cur_size + need > psize:
                        flush_branch()
                        node = self._branch_node(b"", child)
                        need = 2 + len(node)
                    if cur_first is None:
                        cur_first = first_key
                    cur_nodes.append(node)
                    cur_size += need
                flush_branch()
                level = parent

            root = level[0][1] if level else P_INVALID
            last_pg = next_pg - 1 if next_pg > 2 else 1

            # ---- meta pages ----------------------------------------------
            mapsize = max(1 << 20, next_pg * psize)
            for meta_pg, txnid in ((0, 0), (1, 1)):
                meta = bytearray(psize)
                meta[:PAGEHDRSZ] = self._page_hdr(meta_pg, P_META, 0, 0)
                _META.pack_into(meta, PAGEHDRSZ, MDB_MAGIC, MDB_DATA_VERSION, 0, mapsize)
                base = PAGEHDRSZ + _META.size
                # dbs[0] = FREE db: psize in pad, env flags, empty tree
                _DB.pack_into(meta, base, psize, 0, 0, 0, 0, 0, 0, P_INVALID)
                # dbs[1] = MAIN db
                _DB.pack_into(
                    meta, base + _DB.size, 0, 0, depth,
                    n_branch, n_leaf, n_ovf, len(records), root,
                )
                struct.pack_into("<QQ", meta, base + 2 * _DB.size, last_pg, txnid)
                emit(meta_pg, bytes(meta))

            # make sure the file covers the last page
            f.seek(0, os.SEEK_END)
            end = f.tell()
            want = next_pg * psize
            if end < want:
                f.truncate(want)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            self.commit()
