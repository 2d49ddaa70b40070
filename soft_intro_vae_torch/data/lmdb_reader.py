"""First-party read-only LMDB cursor (the port's copy of the JAX package's
data/lmdb_reader.py; no ``lmdb`` package needed).

The reference's LSUN dataset creator iterates an LMDB environment with
``lmdb.open(...).begin().cursor()``
(style_soft_intro_vae/dataset_preparation/dataset_tool.py:660-669).
This module implements just enough of the LMDB on-disk format (the OpenLDAP
liblmdb data format, version 1) to do the same from pure Python over ``mmap``:
parse the two meta pages, pick the newest committed one, and walk the main
database's B+tree leaves in key order, following overflow pages for large
values (LSUN values are multi-KB webp/jpg blobs, so F_BIGDATA is the common
case).

Struct layout (64-bit little-endian, lmdb.h/mdb.c 0.9.x):

  MDB_page header (16 bytes):
      u64 pgno | u16 pad | u16 flags | u16 lower, u16 upper
      (for P_OVERFLOW pages the lower/upper slot holds u32 page count)
  MDB_meta (after the header on pages 0 and 1):
      u32 magic=0xBEEFC0DE | u32 version=1 | u64 address | u64 mapsize
      | MDB_db dbs[2] | u64 last_pg | u64 txnid
  MDB_db (48 bytes):
      u32 pad | u16 flags | u16 depth | u64 branch_pages | u64 leaf_pages
      | u64 overflow_pages | u64 entries | u64 root
      (dbs[0].pad doubles as the environment page size, mdb.c mm_psize)
  MDB_node (8-byte header at each ptr offset):
      u16 lo | u16 hi | u16 flags | u16 ksize | key bytes | value
      leaf:   datasize = lo | hi<<16; F_BIGDATA(0x01) -> value is a u64
              overflow pgno after the key, data at pgno*psize+16
      branch: child pgno = lo | hi<<16 | flags<<32
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE
MDB_DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16
P_INVALID = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")          # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")         # pad, flags, depth, branch, leaf, ovf, entries, root
_TAIL = struct.Struct("<QQ")             # last_pg, txnid
_NODE = struct.Struct("<HHHH")           # lo, hi, flags, ksize


class LMDBFormatError(ValueError):
    pass


class _Meta:
    __slots__ = ("psize", "txnid", "main_root", "main_depth", "main_entries",
                 "main_flags")


def _parse_meta(buf: memoryview, off: int) -> Optional[_Meta]:
    magic, version, _addr, _mapsize = _META.unpack_from(buf, off + PAGEHDRSZ)
    if magic != MDB_MAGIC:
        return None
    if version != MDB_DATA_VERSION:
        raise LMDBFormatError(f"unsupported LMDB data version {version}")
    o = off + PAGEHDRSZ + _META.size
    free_db = _DB.unpack_from(buf, o)
    main_db = _DB.unpack_from(buf, o + _DB.size)
    last_pg, txnid = _TAIL.unpack_from(buf, o + 2 * _DB.size)
    m = _Meta()
    m.psize = free_db[0]                 # mm_psize lives in dbs[0].md_pad
    m.txnid = txnid
    m.main_flags = main_db[1]
    m.main_depth = main_db[2]
    m.main_entries = main_db[6]
    m.main_root = main_db[7]
    return m


class LMDBReader:
    """Read-only iterator over an LMDB environment's main database.

    Usage (mirrors the reference's txn.cursor() loop):

        with LMDBReader("lsun/bedroom_train_lmdb") as db:
            print(len(db))                   # txn.stat()['entries']
            for key, value in db.items():
                ...

    ``path`` may be the environment directory (containing ``data.mdb``) or
    a direct path to the data file (an ``MDB_NOSUBDIR`` environment).
    """

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self.path = path
        self._f = open(path, "rb")
        try:
            self._mm: Optional[mmap.mmap] = mmap.mmap(
                self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except Exception:
            self._f.close()
            raise
        self._buf = memoryview(self._mm)
        m0 = _parse_meta(self._buf, 0)
        if m0 is None:
            raise LMDBFormatError(f"{path}: not an LMDB data file (bad magic)")
        # page 1 sits at psize; both meta pages share the environment psize
        m1 = _parse_meta(self._buf, m0.psize)
        # newest committed meta wins (mdb.c mdb_env_pick_meta)
        self.meta = m0 if (m1 is None or m0.txnid >= m1.txnid) else m1
        self.psize = self.meta.psize
        if self.psize < 512 or self.psize & (self.psize - 1):
            raise LMDBFormatError(f"implausible page size {self.psize}")
        if self.meta.main_flags & ~0x1F:
            # DUPSORT etc. main-DB flags we don't implement would change the
            # leaf layout; LSUN environments use a plain main DB
            raise LMDBFormatError(
                f"unsupported main-db flags 0x{self.meta.main_flags:x}")

    # -- context manager -------------------------------------------------
    def __enter__(self) -> "LMDBReader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        if self._buf is not None:
            self._buf.release()
            self._buf = None
        if self._mm is not None:
            self._mm.close()
            self._mm = None
        self._f.close()

    # -- stats -----------------------------------------------------------
    def __len__(self) -> int:
        """entries of the main DB (txn.stat()['entries'])."""
        return self.meta.main_entries

    # -- page access -----------------------------------------------------
    def _page(self, pgno: int) -> Tuple[int, int]:
        """-> (byte offset, flags) of page ``pgno``, with bound checks."""
        off = pgno * self.psize
        if pgno == P_INVALID or off + PAGEHDRSZ > len(self._buf):
            raise LMDBFormatError(f"page {pgno} out of bounds")
        flags = struct.unpack_from("<H", self._buf, off + 10)[0]
        return off, flags

    def _iter_leaves(self, root: int) -> Iterator[int]:
        """Depth-first left-to-right leaf page offsets under ``root``."""
        stack = [root]
        # guard against cycles in a corrupt tree: visit each page once
        seen = set()
        while stack:
            pgno = stack.pop()
            if pgno in seen:
                raise LMDBFormatError(f"page cycle at {pgno}")
            seen.add(pgno)
            off, flags = self._page(pgno)
            if flags & P_LEAF:
                yield off
            elif flags & P_BRANCH:
                lower = struct.unpack_from("<H", self._buf, off + 12)[0]
                nkeys = (lower - PAGEHDRSZ) >> 1
                kids = []
                for i in range(nkeys):
                    ptr = struct.unpack_from("<H", self._buf, off + PAGEHDRSZ + 2 * i)[0]
                    lo, hi, nflags, _ks = _NODE.unpack_from(self._buf, off + ptr)
                    kids.append(lo | hi << 16 | nflags << 32)
                stack.extend(reversed(kids))  # left-to-right order
            else:
                raise LMDBFormatError(f"page {pgno}: unexpected flags 0x{flags:x}")

    def _overflow_data(self, pgno: int, size: int) -> bytes:
        off, flags = self._page(pgno)
        if not flags & P_OVERFLOW:
            raise LMDBFormatError(f"page {pgno}: expected overflow page")
        start = off + PAGEHDRSZ
        if start + size > len(self._buf):
            raise LMDBFormatError(f"overflow value at page {pgno} truncated")
        # data runs contiguously across the reserved overflow pages
        return bytes(self._buf[start:start + size])

    # -- cursor ----------------------------------------------------------
    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        """(key, value) pairs of the main DB in key order."""
        root = self.meta.main_root
        if root == P_INVALID:  # empty environment
            return
        for off in self._iter_leaves(root):
            flags = struct.unpack_from("<H", self._buf, off + 10)[0]
            if flags & P_LEAF2:
                raise LMDBFormatError("MDB_DUPFIXED leaf pages not supported")
            lower = struct.unpack_from("<H", self._buf, off + 12)[0]
            nkeys = (lower - PAGEHDRSZ) >> 1
            for i in range(nkeys):
                ptr = struct.unpack_from("<H", self._buf, off + PAGEHDRSZ + 2 * i)[0]
                base = off + ptr
                lo, hi, nflags, ksize = _NODE.unpack_from(self._buf, base)
                key = bytes(self._buf[base + 8: base + 8 + ksize])
                dsize = lo | hi << 16
                if nflags & F_BIGDATA:
                    ov = struct.unpack_from("<Q", self._buf, base + 8 + ksize)[0]
                    yield key, self._overflow_data(ov, dsize)
                elif nflags & (F_SUBDATA | F_DUPDATA):
                    raise LMDBFormatError("DUPSORT sub-databases not supported")
                else:
                    vstart = base + 8 + ksize
                    yield key, bytes(self._buf[vstart: vstart + dsize])

    def keys(self) -> Iterator[bytes]:
        for k, _ in self.items():
            yield k
