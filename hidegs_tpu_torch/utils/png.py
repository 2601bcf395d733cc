"""PNG reading and writing with numpy and zlib alone.

The JAX package reads and writes every image through Pillow
(hidegs_tpu/data/cameras.py, hidegs_tpu/evaluate.py:save_png). The port's
serving path does not need it: `read_image` decodes the PNGs a scene holds
(8-bit grayscale, grayscale + alpha, RGB and RGBA, and 16-bit grayscale such
as the inverse-depth maps, non-interlaced, every filter type) into the array
`np.asarray(PIL.Image.open(path))` gives, and `write_png` encodes 8-bit RGB,
8-bit grayscale and 16-bit grayscale (the arrays `PIL.Image.fromarray`
saves as modes RGB, L and I;16); `encode_png` gives the same file as bytes.
Any other file (interlaced or palette PNGs, other bit depths, JPEG) goes to
Pillow, imported only then; without Pillow that raises an ImportError naming
the file.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type → channels, for the colour types this decoder reads
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


class _Unsupported(Exception):
    """A file this decoder does not read; the message says why."""


def _chunks(data: bytes, path: str):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without an IEND chunk")


def _paeth_row(filt: bytearray, prev: bytearray, bpp: int) -> bytearray:
    cur = bytearray(filt)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[i] = (cur[i] + pred) & 0xFF
    return cur


def _average_row(filt: bytearray, prev: bytearray, bpp: int) -> bytearray:
    cur = bytearray(filt)
    for i in range(len(cur)):
        a = cur[i - bpp] if i >= bpp else 0
        cur[i] = (cur[i] + ((a + prev[i]) >> 1)) & 0xFF
    return cur


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int, path: str) -> np.ndarray:
    """Undo the per-row filters of (height, 1 + stride) scanlines. None, Sub
    and Up run as numpy ops per row; Average and Paeth, whose every byte
    depends on the one before it, as a Python loop over the row's bytes."""
    out = np.empty((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(raw[y, 0])
        filt = raw[y, 1:]
        if kind == 0:
            cur = filt
        elif kind == 1:
            cur = (np.cumsum(filt.reshape(-1, bpp), axis=0, dtype=np.uint64) & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:
            cur = filt + prev  # uint8 arithmetic wraps mod 256
        elif kind == 3:
            cur = np.frombuffer(_average_row(bytearray(filt), bytearray(prev), bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_paeth_row(bytearray(filt), bytearray(prev), bpp), np.uint8)
        else:
            raise ValueError(f"{path}: row {y} has PNG filter type {kind}, not one of 0-4")
        out[y] = cur
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """Decode a PNG this module reads: (H, W) for grayscale, (H, W, C)
    otherwise, uint8 or (16-bit grayscale) uint16, as Pillow's array of the
    same file. Raises _Unsupported for the files `read_image` hands to
    Pillow."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(data: bytes, path: str = "<bytes>") -> np.ndarray:
    """`read_png` of a file's bytes; `path` names it in errors."""
    if not data.startswith(SIGNATURE):
        raise _Unsupported("not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    width, height, depth, colour, _compression, _filter, interlace = header
    if interlace:
        raise _Unsupported("an interlaced PNG")
    if colour not in _CHANNELS:
        raise _Unsupported(f"a PNG of colour type {colour}")
    if depth != 8 and not (depth == 16 and colour == 0):
        raise _Unsupported(f"a {depth}-bit PNG of colour type {colour}")
    channels = _CHANNELS[colour]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"{path}: PNG data holds {raw.size} bytes, expected {height * (stride + 1)}")
    pixels = _unfilter(raw.reshape(height, stride + 1), height, stride, bpp, path)
    if depth == 16:
        return pixels.view(">u2").astype(np.uint16).reshape(height, width)
    shape = (height, width) if channels == 1 else (height, width, channels)
    return pixels.reshape(shape)


def _read_with_pil(path: str, why: str) -> np.ndarray:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"{path} is {why}; reading it needs Pillow, which is not installed") from e
    with Image.open(path) as img:
        # palette and bilevel images come out as the pixels they stand for
        if img.mode in ("P", "PA"):
            img = img.convert("RGBA")
        elif img.mode == "1":
            img = img.convert("L")
        return np.asarray(img)


def read_image(path: str) -> np.ndarray:
    """The pixels of image file `path`, as `np.asarray(PIL.Image.open(path))`
    gives them (palette images expanded to RGBA, bilevel ones to 8-bit
    grayscale). PNGs this module reads are decoded here; any other file goes
    to Pillow (imported only then)."""
    try:
        return read_png(path)
    except _Unsupported as e:
        return _read_with_pil(path, str(e))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def encode_png(pixels: np.ndarray) -> bytes:
    """The PNG file of an (H, W, 3) uint8 array (8-bit RGB), an (H, W) uint8
    array (8-bit grayscale) or an (H, W) uint16 array (16-bit grayscale),
    as bytes (filter type 0 on every row, zlib at Pillow's default level 6)."""
    pixels = np.ascontiguousarray(pixels)
    if pixels.ndim == 3 and pixels.shape[2] == 3 and pixels.dtype == np.uint8:
        depth, colour, data = 8, 2, pixels
    elif pixels.ndim == 2 and pixels.dtype == np.uint8:
        depth, colour, data = 8, 0, pixels
    elif pixels.ndim == 2 and pixels.dtype == np.uint16:
        depth, colour, data = 16, 0, pixels.astype(">u2")  # PNG samples are big-endian
    else:
        raise ValueError("write_png takes an (H, W, 3) uint8, (H, W) uint8 or (H, W) uint16 array, "
                         f"got {pixels.dtype} {pixels.shape}")
    height, width = pixels.shape[:2]
    row_bytes = data.reshape(height, -1).view(np.uint8)
    rows = np.zeros((height, 1 + row_bytes.shape[1]), np.uint8)  # column 0: filter type 0
    rows[:, 1:] = row_bytes
    return b"".join([
        SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth, colour, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)),
        _chunk(b"IEND", b""),
    ])


def write_png(path: str, pixels: np.ndarray) -> None:
    """Write `encode_png(pixels)` to `path`."""
    data = encode_png(pixels)
    with open(path, "wb") as f:
        f.write(data)
