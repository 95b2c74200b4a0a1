"""TensorFlow TensorBundle checkpoints, read and written in pure Python.

The port's own copy of ``lstm_unet_tpu/checkpoint/tf_bundle.py`` (numpy
only), for ``checkpoint/tf_import.py``. A TF2 checkpoint is

    <prefix>.index                 an SSTable: names -> BundleEntryProto
    <prefix>.data-0000N-of-0000M   the tensors' little-endian bytes

The SSTable (LevelDB table: prefix-compressed key blocks with restart
points, 5-byte block trailers holding the compression type and a masked
crc32c, an index block, a 48-byte footer ending in the table magic) is read
with snappy-compressed blocks supported, and written uncompressed; the
protos are decoded with a minimal wire-format parser. Bundles written here
are readable by TensorFlow. One difference from the reference's copy: a
bfloat16 tensor loads as float32 (exactly: its bits are the high half of an
f32), since numpy has no bfloat16 without ``ml_dtypes``, which the port
does not need.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Tuple

import numpy as np

# LevelDB/TF table magic (lib/io/format): little-endian at the end of footer.
_TABLE_MAGIC = 0xDB4775248B80FB57
_FOOTER_LEN = 48  # 2 max-length BlockHandles (40) + 8-byte magic
_BLOCK_TRAILER_LEN = 5  # 1-byte compression type + 4-byte masked crc32c

# tensorflow DataType enum values (types.proto) -> numpy dtypes; bfloat16
# (14) is stored as its uint16 bits and widened to float32 on load
_BF16 = 14
_DTYPES = {
    1: np.float32, 2: np.float64, 3: np.int32, 4: np.uint8, 5: np.int16,
    6: np.int8, 9: np.int64, 10: np.bool_, _BF16: np.uint16, 17: np.uint16,
    19: np.float16, 22: np.uint32, 23: np.uint64,
}
_DTYPE_CODES = {np.dtype(dt): code for code, dt in _DTYPES.items() if code != _BF16}


# --------------------------------------------------------------------------
# crc32c (Castagnoli), table-driven, with the TF/LevelDB masking
# --------------------------------------------------------------------------

_CRC_TABLE: List[int] = []


def _crc_table() -> List[int]:
    if not _CRC_TABLE:
        poly = 0x82F63B78  # reversed Castagnoli polynomial
        for n in range(256):
            c = n
            for _ in range(8):
                c = (c >> 1) ^ poly if c & 1 else c >> 1
            _CRC_TABLE.append(c)
    return _CRC_TABLE


_PARALLEL_MIN = 1 << 16  # bytes; shorter data takes the byte loop
_LANES = 8192            # chunks summed in parallel by the numpy path


def _slice4_tables() -> np.ndarray:
    """``[4, 256]`` uint32: the slicing-by-4 tables (row k: a byte followed
    by k zero bytes)."""
    t = np.zeros((4, 256), np.uint32)
    t[0] = _crc_table()
    for k in range(1, 4):
        t[k] = (t[k - 1] >> 8) ^ t[0][t[k - 1] & 0xFF]
    return t


def _feed_words(reg: np.ndarray, words: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Registers ``reg [N]`` after the little-endian words ``[N, M]``."""
    for j in range(words.shape[1]):
        x = reg ^ words[:, j]
        reg = t[3][x & 0xFF] ^ t[2][(x >> 8) & 0xFF] ^ t[1][(x >> 16) & 0xFF] ^ t[0][x >> 24]
    return reg


def _crc_register_parallel(buf: np.ndarray, reg: int) -> Tuple[int, int]:
    """The register after the first ``N * L`` bytes of ``buf``, and N * L.

    The register update is linear over GF(2) in (register, data), so each of
    N chunks of L bytes is summed from a zero register at once, and the
    chunks are joined in order: ``reg = A_L(reg) ^ r_i``, with ``A_L`` (L zero
    bytes fed to a register) applied through four byte tables built from its
    values on the 32 unit registers."""
    t = _slice4_tables()
    length = 4 * max(1, len(buf) // (4 * _LANES))
    n = len(buf) // length
    words = buf[:n * length].view("<u4").reshape(n, length // 4).astype(np.uint32)
    chunks = _feed_words(np.zeros(n, np.uint32), words, t).tolist()
    unit = _feed_words(np.uint32(1) << np.arange(32, dtype=np.uint32),
                       np.zeros((32, length // 4), np.uint32), t)
    bits = (np.arange(256)[:, None] >> np.arange(8)) & 1  # [256, 8]
    shift = [np.bitwise_xor.reduce(np.where(bits, unit[8 * k:8 * k + 8], 0), axis=1).tolist()
             for k in range(4)]
    s0, s1, s2, s3 = shift
    for r in chunks:
        reg = s0[reg & 0xFF] ^ s1[(reg >> 8) & 0xFF] ^ s2[(reg >> 16) & 0xFF] ^ s3[reg >> 24] ^ r
    return reg, n * length


def crc32c(data: bytes, crc: int = 0) -> int:
    """CRC-32C of ``data`` (continuing ``crc``); data of 64 KiB or more is
    summed in parallel chunks with numpy, the same value as the byte loop."""
    table = _crc_table()
    c = crc ^ 0xFFFFFFFF
    start = 0
    if len(data) >= _PARALLEL_MIN:
        c, start = _crc_register_parallel(np.frombuffer(data, np.uint8), c)
    for b in memoryview(data)[start:]:
        c = table[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


def masked_crc32c(data: bytes) -> int:
    """LevelDB 'masked' crc: rotated and offset so crcs of crcs stay sane."""
    c = crc32c(data)
    return (((c >> 15) | (c << 17)) + 0xA282EAD8) & 0xFFFFFFFF


# --------------------------------------------------------------------------
# varint + minimal protobuf wire-format
# --------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _write_varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def parse_proto(buf: bytes) -> Dict[int, list]:
    """Decode one protobuf message into {field_number: [raw values]}.

    Varint fields decode to int, fixed32/64 to int, length-delimited to
    bytes (nested messages are re-parsed by the caller).
    """
    fields: Dict[int, list] = {}
    pos = 0
    while pos < len(buf):
        tag, pos = _read_varint(buf, pos)
        fno, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = struct.unpack_from("<Q", buf, pos)[0]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val = buf[pos: pos + ln]
            pos += ln
        elif wire == 5:
            val = struct.unpack_from("<I", buf, pos)[0]
            pos += 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(fno, []).append(val)
    return fields


def _emit_field(fno: int, wire: int, payload) -> bytes:
    tag = _write_varint((fno << 3) | wire)
    if wire == 0:
        return tag + _write_varint(payload)
    if wire == 2:
        return tag + _write_varint(len(payload)) + payload
    raise ValueError(wire)


# --------------------------------------------------------------------------
# snappy decompression (block format) — read-side only
# --------------------------------------------------------------------------


def snappy_decompress(buf: bytes) -> bytes:
    out_len, pos = _read_varint(buf, 0)
    out = bytearray()
    while pos < len(buf):
        tag = buf[pos]
        pos += 1
        kind = tag & 3
        if kind == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nbytes = ln - 59
                ln = int.from_bytes(buf[pos: pos + nbytes], "little")
                pos += nbytes
            ln += 1
            out += buf[pos: pos + ln]
            pos += ln
        else:  # copy
            if kind == 1:
                ln = ((tag >> 2) & 7) + 4
                off = ((tag >> 5) << 8) | buf[pos]
                pos += 1
            elif kind == 2:
                ln = (tag >> 2) + 1
                off = int.from_bytes(buf[pos: pos + 2], "little")
                pos += 2
            else:
                ln = (tag >> 2) + 1
                off = int.from_bytes(buf[pos: pos + 4], "little")
                pos += 4
            if off == 0:
                raise ValueError("snappy: zero copy offset")
            for _ in range(ln):  # overlapping copies are defined byte-wise
                out.append(out[-off])
    if len(out) != out_len:
        raise ValueError("snappy: length mismatch")
    return bytes(out)


# --------------------------------------------------------------------------
# SSTable read
# --------------------------------------------------------------------------


def _read_block(data: bytes, offset: int, size: int, verify: bool) -> bytes:
    content = data[offset: offset + size]
    ctype = data[offset + size]
    if verify:
        stored = struct.unpack_from("<I", data, offset + size + 1)[0]
        if masked_crc32c(data[offset: offset + size + 1]) != stored:
            raise ValueError(f"block crc mismatch at offset {offset}")
    if ctype == 0:
        return content
    if ctype == 1:
        return snappy_decompress(content)
    raise ValueError(f"unsupported block compression {ctype}")


def _iter_block_entries(block: bytes) -> Iterator[Tuple[bytes, bytes]]:
    """Yield (key, value) from one table block (prefix-compressed entries)."""
    if len(block) < 4:
        return
    num_restarts = struct.unpack_from("<I", block, len(block) - 4)[0]
    data_end = len(block) - 4 * (num_restarts + 1)
    pos = 0
    key = b""
    while pos < data_end:
        shared, pos = _read_varint(block, pos)
        non_shared, pos = _read_varint(block, pos)
        value_len, pos = _read_varint(block, pos)
        key = key[:shared] + block[pos: pos + non_shared]
        pos += non_shared
        value = block[pos: pos + value_len]
        pos += value_len
        yield key, value


def read_table(path: str, verify_crc: bool = True) -> Dict[bytes, bytes]:
    """Read an entire SSTable file into an ordered {key: value} dict."""
    with open(path, "rb") as f:
        data = f.read()
    if len(data) < _FOOTER_LEN:
        raise ValueError(f"{path}: too short to be a table")
    footer = data[-_FOOTER_LEN:]
    magic = struct.unpack_from("<Q", footer, _FOOTER_LEN - 8)[0]
    if magic != _TABLE_MAGIC:
        raise ValueError(f"{path}: bad table magic {magic:#x}")
    # metaindex handle then index handle, both varint (offset, size)
    pos = 0
    _, pos = _read_varint(footer, pos)   # metaindex offset (unused)
    _, pos = _read_varint(footer, pos)   # metaindex size
    idx_off, pos = _read_varint(footer, pos)
    idx_size, pos = _read_varint(footer, pos)
    index = _read_block(data, idx_off, idx_size, verify_crc)
    out: Dict[bytes, bytes] = {}
    for _, handle in _iter_block_entries(index):
        off, hpos = _read_varint(handle, 0)
        size, _ = _read_varint(handle, hpos)
        for k, v in _iter_block_entries(_read_block(data, off, size, verify_crc)):
            out[k] = v
    return out


# --------------------------------------------------------------------------
# SSTable write (uncompressed blocks, restart interval 16)
# --------------------------------------------------------------------------

_RESTART_INTERVAL = 16
_BLOCK_SIZE = 4096


class _BlockBuilder:
    def __init__(self):
        self.buf = bytearray()
        self.restarts = [0]
        self.counter = 0
        self.last_key = b""

    def add(self, key: bytes, value: bytes) -> None:
        shared = 0
        if self.counter < _RESTART_INTERVAL:
            ml = min(len(key), len(self.last_key))
            while shared < ml and key[shared] == self.last_key[shared]:
                shared += 1
        else:
            self.restarts.append(len(self.buf))
            self.counter = 0
        self.buf += _write_varint(shared)
        self.buf += _write_varint(len(key) - shared)
        self.buf += _write_varint(len(value))
        self.buf += key[shared:]
        self.buf += value
        self.last_key = key
        self.counter += 1

    def finish(self) -> bytes:
        out = bytes(self.buf)
        for r in self.restarts:
            out += struct.pack("<I", r)
        return out + struct.pack("<I", len(self.restarts))

    def __len__(self):
        return len(self.buf)


class TableWriter:
    """Minimal SSTable writer (keys must be added in sorted order)."""

    def __init__(self, path: str):
        self._f = open(path, "wb")
        self._offset = 0
        self._block = _BlockBuilder()
        self._index: List[Tuple[bytes, Tuple[int, int]]] = []
        self._last_key = b""

    def _flush_block(self) -> None:
        if not self._block.buf:
            return
        content = self._block.finish()
        handle = (self._offset, len(content))
        blob = content + b"\x00"
        crc = masked_crc32c(blob)
        self._f.write(blob + struct.pack("<I", crc))
        self._offset += len(content) + _BLOCK_TRAILER_LEN
        self._index.append((self._last_key, handle))
        self._block = _BlockBuilder()

    def add(self, key: bytes, value: bytes) -> None:
        if key <= self._last_key and self._last_key:
            raise ValueError("keys must be added in strictly sorted order")
        self._block.add(key, value)
        self._last_key = key
        if len(self._block) >= _BLOCK_SIZE:
            self._flush_block()

    def finish(self) -> None:
        if self._block.buf:
            self._flush_block()
        # metaindex block (empty)
        meta = _BlockBuilder().finish()
        meta_handle = (self._offset, len(meta))
        blob = meta + b"\x00"
        self._f.write(blob + struct.pack("<I", masked_crc32c(blob)))
        self._offset += len(meta) + _BLOCK_TRAILER_LEN
        # index block
        idx = _BlockBuilder()
        for key, (off, size) in self._index:
            idx.add(key, _write_varint(off) + _write_varint(size))
        content = idx.finish()
        idx_handle = (self._offset, len(content))
        blob = content + b"\x00"
        self._f.write(blob + struct.pack("<I", masked_crc32c(blob)))
        self._offset += len(content) + _BLOCK_TRAILER_LEN
        footer = (_write_varint(meta_handle[0]) + _write_varint(meta_handle[1])
                  + _write_varint(idx_handle[0]) + _write_varint(idx_handle[1]))
        footer += b"\x00" * (_FOOTER_LEN - 8 - len(footer))
        footer += struct.pack("<Q", _TABLE_MAGIC)
        self._f.write(footer)
        self._f.close()


# --------------------------------------------------------------------------
# TensorBundle
# --------------------------------------------------------------------------


@dataclass
class BundleEntry:
    dtype: np.dtype
    shape: Tuple[int, ...]
    shard_id: int
    offset: int
    size: int
    crc: int = 0
    bfloat16: bool = False


@dataclass
class TFBundle:
    """A parsed TensorBundle checkpoint (``<prefix>.index`` + data shards)."""

    prefix: str
    num_shards: int = 1
    entries: Dict[str, BundleEntry] = field(default_factory=dict)
    raw: Dict[str, bytes] = field(default_factory=dict)  # non-tensor keys

    @staticmethod
    def open(prefix: str, verify_crc: bool = True) -> "TFBundle":
        table = read_table(prefix + ".index", verify_crc)
        bundle = TFBundle(prefix=prefix)
        for key, value in table.items():
            if key == b"":
                header = parse_proto(value)
                bundle.num_shards = header.get(1, [1])[0]
                continue
            msg = parse_proto(value)
            shape: Tuple[int, ...] = ()
            if 2 in msg:  # TensorShapeProto
                sp = parse_proto(msg[2][0])
                dims = []
                for d in sp.get(2, []):  # repeated Dim
                    dims.append(parse_proto(d).get(1, [0])[0])
                shape = tuple(dims)
            name = key.decode("utf-8")
            code = msg.get(1, [1])[0]
            entry = BundleEntry(
                dtype=np.dtype(_DTYPES[code]),
                shape=shape,
                shard_id=msg.get(3, [0])[0],
                offset=msg.get(4, [0])[0],
                size=msg.get(5, [0])[0],
                crc=msg.get(6, [0])[0],
                bfloat16=code == _BF16,
            )
            if 7 in msg:  # partitioned variables: out of scope
                raise NotImplementedError(f"sliced tensor {name!r}")
            bundle.entries[name] = entry
        return bundle

    def _shard_path(self, shard_id: int) -> str:
        return f"{self.prefix}.data-{shard_id:05d}-of-{self.num_shards:05d}"

    def list_variables(self) -> List[Tuple[str, Tuple[int, ...]]]:
        return [(n, e.shape) for n, e in sorted(self.entries.items())]

    def load(self, name: str, verify_crc: bool = False) -> np.ndarray:
        e = self.entries[name]
        with open(self._shard_path(e.shard_id), "rb") as f:
            f.seek(e.offset)
            buf = f.read(e.size)
        if verify_crc and e.crc and masked_crc32c(buf) != e.crc:
            raise ValueError(f"data crc mismatch for {name!r}")
        arr = np.frombuffer(buf, dtype=e.dtype).reshape(e.shape)
        if e.bfloat16:
            return (arr.astype(np.uint32) << 16).view(np.float32)
        return arr


def write_bundle(prefix: str, tensors: Dict[str, np.ndarray]) -> None:
    """Write a single-shard TensorBundle readable by real TensorFlow.

    The way back: params exported for a TF2 stack
    (``tf.train.load_checkpoint(prefix).get_tensor(name)``).
    """
    os.makedirs(os.path.dirname(prefix) or ".", exist_ok=True)
    names = sorted(tensors)
    data_path = f"{prefix}.data-00000-of-00001"
    entries: Dict[str, BundleEntry] = {}
    with open(data_path, "wb") as f:
        offset = 0
        for name in names:
            # NOT ascontiguousarray: it promotes 0-d arrays to 1-d;
            # tobytes() already serializes in C order for any layout
            arr = np.asarray(tensors[name])
            buf = arr.tobytes()
            f.write(buf)
            entries[name] = BundleEntry(
                dtype=arr.dtype, shape=arr.shape, shard_id=0,
                offset=offset, size=len(buf), crc=masked_crc32c(buf))
            offset += len(buf)

    w = TableWriter(prefix + ".index")
    header = _emit_field(1, 0, 1)  # num_shards = 1
    # endianness LITTLE=0 (field 2, default) / version (field 3): producer 1
    header += _emit_field(3, 2, _emit_field(1, 0, 1))
    w.add(b"", header)
    for name in names:
        e = entries[name]
        dims = b"".join(
            _emit_field(2, 2, _emit_field(1, 0, d)) for d in e.shape)
        msg = _emit_field(1, 0, _DTYPE_CODES[np.dtype(e.dtype)])
        msg += _emit_field(2, 2, dims)
        if e.shard_id:
            msg += _emit_field(3, 0, e.shard_id)
        msg += _emit_field(4, 0, e.offset) if e.offset else b""
        msg += _emit_field(5, 0, e.size)
        msg += _emit_field(6, 0, e.crc)
        w.add(name.encode("utf-8"), msg)
    w.finish()
