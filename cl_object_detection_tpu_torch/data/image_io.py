"""Image decode and PNG encode for the host pipeline.

``read_image(path)`` / ``decode_image(data)`` return an (H, W, 3) uint8
RGB array. PNG is decoded here, with ``zlib`` and numpy: 8-bit greyscale
(colour type 0) and RGB (colour type 2), no interlace. Rows filtered
with types 0 (None), 1 (Sub) and 2 (Up) are undone a row at a time in
numpy. Types 3 (Average) and 4 (Paeth) depend on the pixel to the left,
so a file with such rows (PIL and libpng pick a filter per row, Paeth
included) goes to OpenCV or PIL when either imports, and is undone byte
by byte in Python, slowly, only without them. ``write_png`` writes
8-bit RGB or greyscale with filter type 0 on every row, so reading what
it wrote is an inflate and a reshape. Any other input (JPEG, BMP, a PNG
variant outside that set) goes to OpenCV, else to PIL, when either
imports; with neither it raises ``ImportError`` naming the format and
the two libraries. Nothing is guessed.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3}           # colour type -> samples per pixel (8-bit)
_MAGIC = ((b"\xff\xd8\xff", "JPEG"), (b"BM", "BMP"), (b"GIF8", "GIF"),
          (b"RIFF", "WebP"), (b"II*\x00", "TIFF"), (b"MM\x00*", "TIFF"),
          (PNG_SIGNATURE, "PNG"))


class _Unsupported(Exception):
    """A PNG left to OpenCV or PIL (the reason is the message)."""


def read_image(path: str) -> np.ndarray:
    """Decode the image file at ``path`` to (H, W, 3) uint8 RGB."""
    with open(path, "rb") as f:
        data = f.read()
    return decode_image(data, name=path)


def decode_image(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """Decode an encoded image to (H, W, 3) uint8 RGB (module docstring)."""
    reason = None
    if data.startswith(PNG_SIGNATURE):
        try:
            return _decode_png(data)
        except _Unsupported as e:
            reason = str(e)
    fmt = next((f for magic, f in _MAGIC if data.startswith(magic)), "unknown format")
    img = _decode_with_library(data)
    if img is not None:
        return img
    what = f"{fmt} ({reason})" if reason else fmt
    raise ImportError(
        f"{name}: {what} is decoded through OpenCV (cv2) or PIL, and neither "
        "imports; only 8-bit greyscale or RGB non-interlaced PNG is decoded "
        "without them")


def _library():
    """The ``cv2`` module, else PIL's ``Image``; None if neither imports."""
    try:
        import cv2
        return cv2
    except ImportError:
        pass
    try:
        from PIL import Image
        return Image
    except ImportError:
        return None


def _decode_with_library(data: bytes):
    """(H, W, 3) uint8 RGB through cv2, else PIL; None if neither imports.
    Raises ValueError when the library cannot decode the bytes."""
    lib = _library()
    if lib is None:
        return None
    if lib.__name__ == "cv2":
        img = lib.imdecode(np.frombuffer(data, np.uint8), lib.IMREAD_COLOR)
        if img is None:
            raise ValueError("OpenCV could not decode the image")
        return np.ascontiguousarray(img[:, :, ::-1])
    import io

    with lib.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _chunks(data: bytes):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk")
        crc = struct.unpack(">I", data[pos + 8 + length:pos + 12 + length])[0]
        if zlib.crc32(ctype + body) != crc:
            raise ValueError(f"PNG chunk {ctype!r}: CRC mismatch")
        yield ctype, body
        if ctype == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG without IEND")


def _decode_png(data: bytes) -> np.ndarray:
    header, idat = None, []
    for ctype, body in _chunks(data):
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, comp, filt, interlace = header
    if interlace:
        raise _Unsupported("interlaced PNG")
    if depth != 8 or ctype not in _CHANNELS:
        raise _Unsupported(f"PNG of bit depth {depth}, colour type {ctype}")
    if comp or filt:
        raise ValueError(f"PNG compression {comp} / filter method {filt}")
    bpp = _CHANNELS[ctype]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG data is {len(raw)} bytes, expected {height * (stride + 1)}")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    kinds = rows[:, 0]
    if (kinds > 4).any():
        raise ValueError(f"PNG filter type {int(kinds.max())}")
    if (kinds >= 3).any() and _library() is not None:
        raise _Unsupported("Average or Paeth filtered rows")
    if not kinds.any():
        img = rows[:, 1:].reshape(height, width, bpp)
    else:
        img = _unfilter(rows, kinds, stride, bpp).reshape(height, width, bpp)
    if bpp == 1:
        return np.repeat(img, 3, axis=2)
    return np.ascontiguousarray(img)


def _unfilter(rows: np.ndarray, kinds: np.ndarray, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (PNG specification, section 9)."""
    out = np.zeros((rows.shape[0], stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y, kind in enumerate(kinds):
        line = rows[y, 1:]
        if kind == 0:
            cur = line.copy()
        elif kind == 1:          # Sub: running sum mod 256 per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:          # Up
            cur = line + prior
        else:                    # Average, Paeth (no library): left to right
            cur = _unfilter_sequential(line, prior, bpp, kind)
        out[y] = cur
        prior = cur
    return out


def _unfilter_sequential(line: np.ndarray, prior: np.ndarray, bpp: int, kind: int) -> np.ndarray:
    f, b = line.tolist(), prior.tolist()
    cur = [0] * len(f)
    for i, x in enumerate(f):
        a = cur[i - bpp] if i >= bpp else 0
        up = b[i]
        if kind == 3:
            cur[i] = (x + ((a + up) >> 1)) & 0xFF
        else:
            c = b[i - bpp] if i >= bpp else 0
            p = a + up - c
            pa, pb, pc = abs(p - a), abs(p - up), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (up if pb <= pc else c)
            cur[i] = (x + pred) & 0xFF
    return np.asarray(cur, np.uint8)


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """8-bit RGB (H, W, 3) or greyscale (H, W) uint8 -> PNG bytes, filter
    type 0 on every row."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"write_png takes (H, W) or (H, W, 3) uint8, got "
                         f"{img.dtype} {img.shape}")
    height, width = img.shape[:2]
    ctype = 0 if img.ndim == 2 else 2
    rows = np.zeros((height, width * _CHANNELS[ctype] + 1), np.uint8)
    rows[:, 1:] = img.reshape(height, -1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, 8, ctype, 0, 0, 0)
    return (PNG_SIGNATURE + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), level)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write ``img`` (see ``encode_png``) to ``path``."""
    data = encode_png(img, level)
    with open(path, "wb") as f:
        f.write(data)
