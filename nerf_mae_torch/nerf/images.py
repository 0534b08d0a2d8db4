"""PNG reading and writing on zlib and numpy, for the scene loader of
run_nerf: non-interlaced 8-bit RGB and RGBA and 16-bit grayscale (depth
maps in 1/depth_scale units), all five row filters.

Resampling (--downscale, depth maps of another size than their colour
frame) needs Pillow's filters and imports it there (`resize`).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type (gray, RGB, RGBA) -> samples per pixel


def _paeth_row(raw: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = prior[x]
        c = prior[x - bpp] if x >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        out[x] = (out[x] + pred) & 0xFF
    return out


def _average_row(raw: bytes, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(raw)
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        out[x] = (out[x] + ((a + prior[x]) >> 1)) & 0xFF
    return out


def _unfilter(data: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """The image bytes [height, stride] of filtered scanlines."""
    rows = np.frombuffer(data, np.uint8)
    if rows.size != height * (stride + 1):
        raise ValueError(f"PNG data has {rows.size} bytes, expected {height * (stride + 1)}")
    rows = rows.reshape(height, stride + 1)
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        kind, raw = rows[y, 0], rows[y, 1:]
        if kind == 0:
            cur = raw
        elif kind == 1:  # sub: a running sum per sample byte, modulo 256
            cur = np.cumsum(raw.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # up
            cur = raw + prior
        elif kind == 3:
            cur = np.frombuffer(_average_row(raw.tobytes(), prior.tobytes(), bpp), np.uint8)
        elif kind == 4:
            cur = np.frombuffer(_paeth_row(raw.tobytes(), prior.tobytes(), bpp), np.uint8)
        else:
            raise ValueError(f"PNG row filter {kind} is not one of 0-4")
        out[y] = cur
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """[H, W, 3] or [H, W, 4] uint8, or [H, W] uint16 (16-bit grayscale)."""
    with open(path, "rb") as f:
        blob = f.read()
    if not blob.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, header, idat = len(_SIGNATURE), None, []
    while pos + 8 <= len(blob):
        length, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        body = blob[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if (depth, color) not in ((8, 2), (8, 6), (16, 0)):
        raise ValueError(f"{path}: {depth}-bit PNG of colour type {color} is not supported "
                         "(8-bit RGB / RGBA, 16-bit grayscale)")
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not supported")
    channels = _CHANNELS[color]
    bpp = channels * depth // 8
    pixels = _unfilter(zlib.decompress(b"".join(idat)), height, width * bpp, bpp)
    if depth == 16:
        return pixels.view(">u2").astype(np.uint16).reshape(height, width)
    return pixels.reshape(height, width, channels)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """An 8-bit RGB [H, W, 3] or RGBA [H, W, 4] uint8 image, or a 16-bit
    grayscale [H, W] uint16 one; rows unfiltered."""
    image = np.asarray(image)
    if image.dtype == np.uint16 and image.ndim == 2:
        depth, color, data = 16, 0, image.astype(">u2").view(np.uint8)
    elif image.dtype == np.uint8 and image.ndim == 3 and image.shape[-1] in (3, 4):
        depth, color, data = 8, (2 if image.shape[-1] == 3 else 6), image
    else:
        raise ValueError(f"write_png takes uint8 [H, W, 3|4] or uint16 [H, W], got "
                         f"{image.dtype} {list(image.shape)}")
    h, w = image.shape[:2]
    rows = np.ascontiguousarray(data).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1).tobytes()
    with open(path, "wb") as f:
        f.write(_SIGNATURE)
        f.write(_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, 0)))
        f.write(_chunk(b"IDAT", zlib.compress(raw)))
        f.write(_chunk(b"IEND", b""))


def resize(image: np.ndarray, size, nearest: bool = False) -> np.ndarray:
    """Pillow's resize of a uint8 or uint16 image to size (w, h): its
    default filter (bicubic), or nearest neighbour."""
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError("resampling an image (--downscale > 1, or a depth map of another "
                          "size than its colour frame) needs Pillow, which is not "
                          "installed") from e
    img = Image.fromarray(image)
    return np.asarray(img.resize(tuple(size), Image.NEAREST) if nearest
                      else img.resize(tuple(size)))
