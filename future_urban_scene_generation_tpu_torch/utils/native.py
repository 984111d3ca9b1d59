"""PNG input and output for the serving entry points, on the standard library.

Counterpart of the JAX package's utils/native.py (``write_png`` :135, ``read_png``
:150, ``AsyncPngWriter`` :82), which binds a C++ encoder and falls back to cv2 or
PIL. Here the codec is ``zlib`` + ``struct`` and the writer pool is a thread pool
(``zlib`` releases the interpreter lock while it compresses), so nothing on the
serving path needs a compiler, cv2 or PIL.

Written files are 8-bit, non-interlaced, filter type 0 on every scanline. The
reader takes 8-bit gray, gray+alpha, RGB and RGBA with all five scanline filters
and returns RGB; palette, 16-bit and interlaced files raise.
"""
from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}  # channels -> PNG colour type
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels
_ZLIB_LEVEL = 1  # the request waits for the encode; size matters less than time


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img_u8: np.ndarray) -> bytes:
    """PNG bytes of a uint8 image: (H, W) gray, (H, W, 3) RGB or (H, W, 4) RGBA."""
    img = np.asarray(img_u8)
    if img.dtype != np.uint8:
        raise TypeError(f"encode_png: uint8 image expected, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[2] not in _COLOR_TYPE or 0 in img.shape:
        raise ValueError(f"encode_png: unsupported image shape {img.shape}")
    h, w, c = img.shape
    rows = np.empty((h, 1 + w * c), np.uint8)
    rows[:, 0] = 0  # filter type None
    rows[:, 1:] = img.reshape(h, w * c)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), _ZLIB_LEVEL))
            + _chunk(b"IEND", b""))


def write_png(path, img_u8: np.ndarray) -> None:
    """Write a uint8 gray / RGB / RGBA image as a PNG file."""
    Path(path).write_bytes(encode_png(img_u8))


def _paeth_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF


def _average_row(cur: bytearray, prev: bytes, bpp: int) -> None:
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF


def _unfilter(raw: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    """Undo the per-scanline filters: (h, w * bpp) uint8 samples."""
    stride = w * bpp
    if len(raw) != h * (stride + 1):
        raise IOError("PNG image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(h, stride + 1)
    filters = rows[:, 0]
    if not filters.any():
        return rows[:, 1:]
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype = int(filters[y])
        line = rows[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:  # Sub: a running sum along the row, per sample, mod 256
            cur = np.cumsum(line.reshape(w, bpp), axis=0, dtype=np.uint8).reshape(stride)
        elif ftype == 2:  # Up
            cur = line + prev
        elif ftype in (3, 4):
            buf = bytearray(line.tobytes())
            (_average_row if ftype == 3 else _paeth_row)(buf, prev.tobytes(), bpp)
            cur = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise IOError(f"PNG scanline {y} has unknown filter type {ftype}")
        out[y] = cur
        prev = out[y]
    return out


def decode_png(data: bytes) -> np.ndarray:
    """Decode PNG bytes to an RGB (H, W, 3) uint8 array (gray replicated, alpha
    dropped). Raises IOError on a corrupt or unsupported file."""
    if data[:8] != _SIGNATURE:
        raise IOError("not a PNG file")
    pos, idat, header = 8, [], None
    while pos + 8 <= len(data):
        (length,), tag = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise IOError("truncated PNG chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise IOError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise IOError(f"unsupported PNG (bit depth {depth}, colour type {ctype}, "
                      f"interlace {interlace}): 8-bit gray/RGB/RGBA only")
    c = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise IOError(f"corrupt PNG image data: {exc}") from exc
    px = _unfilter(raw, h, w, c).reshape(h, w, c)
    if c <= 2:  # gray (+ alpha)
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., :3])


def read_png(path) -> np.ndarray:
    """Decode a PNG file to an RGB (H, W, 3) uint8 array (see :func:`decode_png`)."""
    return decode_png(Path(path).read_bytes())


class AsyncPngWriter:
    """Writes PNGs on a pool of threads: ``submit`` returns at once, ``flush``
    waits for every pending write and returns how many failed."""

    def __init__(self, n_threads: int = 2):
        self._pool = ThreadPoolExecutor(max_workers=n_threads)
        self._pending = []

    def submit(self, path, img_u8: np.ndarray) -> None:
        img = np.ascontiguousarray(img_u8, dtype=np.uint8)
        self._pending.append(self._pool.submit(write_png, path, img))

    def flush(self) -> int:
        errors = sum(1 for f in self._pending if f.exception() is not None)
        self._pending = []
        return errors

    def close(self) -> None:
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
