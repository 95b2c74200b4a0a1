"""Grayscale TIFF read/write in numpy.

Counterpart of ``lstm_unet_tpu/io/tiff.py``. The codec here covers what the
streaming path reads and writes: uncompressed uint8/uint16 grayscale strips
in either byte order. It writes the single-strip little-endian layout of the
reference's native codec (``native/tiffio.cpp``), so masks are byte-for-byte
the reference's. Other TIFFs (compressed, tiled, multi-sample) are read
through cv2 or PIL when one of them imports, and raise otherwise.
"""

from __future__ import annotations

import os
import struct
from typing import Optional

import numpy as np

# tag -> name of the baseline tags the codec reads
_TAGS = {256: "width", 257: "height", 258: "bits", 259: "compression",
         273: "strip_offsets", 277: "samples", 279: "strip_counts",
         284: "planar", 322: "tile_width", 339: "sample_format"}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 16: "Q"}  # BYTE, SHORT, LONG, LONG8


def _read_uncompressed(data: bytes) -> Optional[np.ndarray]:
    """Decode an uncompressed uint8/uint16 grayscale TIFF; None when the file
    uses anything else (compression, tiles, several samples, float)."""
    if data[:2] == b"II":
        bo = "<"
    elif data[:2] == b"MM":
        bo = ">"
    else:
        raise ValueError("not a TIFF file (bad byte-order mark)")
    magic, ifd = struct.unpack_from(bo + "HI", data, 2)
    if magic != 42:
        return None  # BigTIFF and the like
    (n,) = struct.unpack_from(bo + "H", data, ifd)
    tags = {}
    for e in range(n):
        tag, typ, count = struct.unpack_from(bo + "HHI", data, ifd + 2 + 12 * e)
        if tag not in _TAGS or typ not in _TYPE_FMT:
            continue
        fmt = bo + _TYPE_FMT[typ] * count
        size = struct.calcsize(fmt)
        at = ifd + 2 + 12 * e + 8
        if size > 4:
            (at,) = struct.unpack_from(bo + "I", data, at)
        tags[_TAGS[tag]] = struct.unpack_from(fmt, data, at)
    bits = tags.get("bits", (1,))[0]
    if (tags.get("compression", (1,))[0] != 1 or tags.get("samples", (1,))[0] != 1
            or tags.get("sample_format", (1,))[0] != 1 or "tile_width" in tags
            or bits not in (8, 16) or "strip_offsets" not in tags):
        return None
    w, h = tags["width"][0], tags["height"][0]
    raw = b"".join(data[o:o + c] for o, c in
                   zip(tags["strip_offsets"], tags["strip_counts"]))
    dtype = np.dtype(np.uint8) if bits == 8 else np.dtype(bo + "u2")
    arr = np.frombuffer(raw, dtype=dtype, count=h * w).reshape(h, w)
    return arr.astype(arr.dtype.newbyteorder("="))


def _read_with_library(path: str) -> np.ndarray:
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        arr = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if arr is not None:
            return arr[..., 0] if arr.ndim == 3 else arr
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: not an uncompressed uint8/uint16 grayscale TIFF, and "
            "neither cv2 nor PIL is installed to read it") from None
    with Image.open(path) as im:
        arr = np.asarray(im)
    return arr[..., 0] if arr.ndim == 3 else arr


def read_tiff(path: str) -> np.ndarray:
    """Read a grayscale TIFF as a 2-D array in its stored dtype."""
    with open(path, "rb") as f:
        data = f.read()
    arr = _read_uncompressed(data)
    return arr if arr is not None else _read_with_library(path)


def write_tiff(path: str, arr: np.ndarray) -> None:
    """Write a 2-D uint8/uint16 array as a single-strip uncompressed
    little-endian TIFF, atomically (temp file + rename)."""
    arr = np.ascontiguousarray(arr)
    if arr.ndim != 2 or arr.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"TIFF output must be 2-D uint8/uint16, got "
                         f"{arr.dtype} {arr.shape}")
    h, w = arr.shape
    bits = arr.dtype.itemsize * 8
    pix = arr.astype(arr.dtype.newbyteorder("<")).tobytes()
    entries = [(256, 3, w), (257, 3, h), (258, 3, bits), (259, 3, 1),
               (262, 3, 1), (273, 4, 8), (277, 3, 1), (278, 3, h),
               (279, 4, len(pix)), (339, 3, 1)]
    ifd = struct.pack("<H", len(entries)) + b"".join(
        struct.pack("<HHIHH", tag, typ, 1, val, 0) if typ == 3
        else struct.pack("<HHII", tag, typ, 1, val) for tag, typ, val in entries)
    out = struct.pack("<2sHI", b"II", 42, 8 + len(pix)) + pix + ifd + b"\0\0\0\0"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(out)
    os.replace(tmp, path)
