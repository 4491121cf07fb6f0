"""Wire (de)serialization of rollup transactions — big-endian, u32
length-prefixed vectors, 32-byte fr, matching the reference's
common/serialize.hpp readers used by rollup_tx.hpp / root_rollup_tx.hpp
(the format halloumi's tx_rollup.ts / root_rollup.ts encode).

Port of aztec_tpu/rollup/serialize.py: the same bytes both ways.
"""

from __future__ import annotations

import struct
from typing import List, Tuple

from .rollup_circuit import RollupTx
from .root_rollup_circuit import RootRollupTx

HashPath = List[Tuple[int, int]]


class Cursor:
    def __init__(self, data: bytes):
        self.data = data
        self.off = 0

    def u8(self) -> int:
        v = self.data[self.off]
        self.off += 1
        return v

    def u32(self) -> int:
        (v,) = struct.unpack_from(">I", self.data, self.off)
        self.off += 4
        return v

    def fr(self) -> int:
        v = int.from_bytes(self.data[self.off:self.off + 32], "big")
        self.off += 32
        return v

    def buf(self) -> bytes:
        n = self.u32()
        v = self.data[self.off:self.off + n]
        self.off += n
        return v

    def hash_path(self) -> HashPath:
        n = self.u32()
        return [(self.fr(), self.fr()) for _ in range(n)]


def _w_u32(out: bytearray, v: int):
    out += struct.pack(">I", v)


def _w_fr(out: bytearray, v: int):
    out += v.to_bytes(32, "big")


def _w_buf(out: bytearray, b: bytes):
    _w_u32(out, len(b))
    out += b


def _w_path(out: bytearray, p: HashPath):
    _w_u32(out, len(p))
    for (l, r) in p:
        _w_fr(out, l)
        _w_fr(out, r)


def write_rollup_tx(tx: RollupTx) -> bytes:
    """ref: rollup_tx.hpp write (field order is the wire contract)."""
    out = bytearray()
    _w_u32(out, tx.num_txs)
    _w_u32(out, tx.data_start_index)
    _w_u32(out, len(tx.txs))
    for t in tx.txs:
        _w_buf(out, t)
    _w_fr(out, tx.old_data_root)
    _w_fr(out, tx.new_data_root)
    _w_path(out, tx.old_data_path)
    _w_path(out, tx.new_data_path or [])
    _w_fr(out, tx.old_null_root)
    _w_u32(out, len(tx.new_null_roots))
    for r in tx.new_null_roots:
        _w_fr(out, r)
    _w_u32(out, len(tx.old_null_paths))
    for p in tx.old_null_paths:
        _w_path(out, p)
    paths = tx.new_null_paths or []
    _w_u32(out, len(paths))
    for p in paths:
        _w_path(out, p)
    _w_fr(out, tx.data_roots_root)
    _w_u32(out, len(tx.data_roots_paths))
    for p in tx.data_roots_paths:
        _w_path(out, p)
    _w_u32(out, len(tx.data_roots_indicies))
    for i in tx.data_roots_indicies:
        _w_u32(out, i)
    return bytes(out)


def read_rollup_tx(data: bytes, rollup_id: int = 0) -> RollupTx:
    c = Cursor(data)
    num_txs = c.u32()
    data_start_index = c.u32()
    txs = [c.buf() for _ in range(c.u32())]
    old_data_root = c.fr()
    new_data_root = c.fr()
    old_data_path = c.hash_path()
    new_data_path = c.hash_path()
    old_null_root = c.fr()
    new_null_roots = [c.fr() for _ in range(c.u32())]
    old_null_paths = [c.hash_path() for _ in range(c.u32())]
    new_null_paths = [c.hash_path() for _ in range(c.u32())]
    data_roots_root = c.fr()
    data_roots_paths = [c.hash_path() for _ in range(c.u32())]
    data_roots_indicies = [c.u32() for _ in range(c.u32())]
    assert c.off == len(data), "trailing bytes in rollup_tx"
    return RollupTx(
        rollup_id=rollup_id, num_txs=num_txs,
        data_start_index=data_start_index, txs=txs,
        old_data_root=old_data_root, new_data_root=new_data_root,
        old_data_path=old_data_path, old_null_root=old_null_root,
        new_null_roots=new_null_roots, old_null_paths=old_null_paths,
        data_roots_root=data_roots_root, data_roots_paths=data_roots_paths,
        data_roots_indicies=data_roots_indicies,
        new_data_path=new_data_path, new_null_paths=new_null_paths,
    )


def write_root_rollup_tx(tx: RootRollupTx,
                         new_data_roots_path: HashPath | None = None
                         ) -> bytes:
    """ref: root_rollup_tx.hpp write."""
    out = bytearray()
    _w_u32(out, tx.num_inner_proofs)
    _w_u32(out, tx.rollup_id)
    _w_u32(out, len(tx.rollups))
    for r in tx.rollups:
        _w_buf(out, r)
    _w_fr(out, tx.old_data_roots_root)
    _w_fr(out, tx.new_data_roots_root)
    _w_path(out, tx.old_data_roots_path)
    _w_path(out, new_data_roots_path or [])
    return bytes(out)


def read_root_rollup_tx(data: bytes) -> RootRollupTx:
    c = Cursor(data)
    num_inner = c.u32()
    rollup_id = c.u32()
    rollups = [c.buf() for _ in range(c.u32())]
    old_rr = c.fr()
    new_rr = c.fr()
    old_path = c.hash_path()
    c.hash_path()  # new_data_roots_path: re-derived in-circuit
    assert c.off == len(data), "trailing bytes in root_rollup_tx"
    return RootRollupTx(
        num_inner_proofs=num_inner, rollup_id=rollup_id, rollups=rollups,
        old_data_roots_root=old_rr, new_data_roots_root=new_rr,
        old_data_roots_path=old_path,
    )
