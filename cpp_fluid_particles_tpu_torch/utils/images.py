"""Image file writers (PNG + animated GIF), dependency-free.

Copy of ``cpp_fluid_particles_tpu/utils/images.py`` (numpy only, so the
bytes it writes are the JAX package's for the same frames). Replaces the
reference's on-screen GL presentation (and its committed example.gif,
README.md:5) for a headless machine: rendered frames are arrays; these
helpers persist them. The port's native C++ GIF encoder in ``runtime/`` is
used when built (see runtime/gifenc.cpp); this module is the pure-Python
fallback and the PNG path.
"""

from __future__ import annotations

import struct
import zlib
from typing import Iterable, List, Sequence

import numpy as np


def to_uint8(img: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(img) * 255.0 + 0.5, 0, 255).astype(np.uint8)


# ----------------------------------------------------------------------
# PNG
# ----------------------------------------------------------------------

def png_bytes(img: np.ndarray) -> bytes:
    """Encode (H, W, 3) float in [0,1] or uint8 as PNG bytes."""
    arr = img if img.dtype == np.uint8 else to_uint8(img)
    h, w, _ = arr.shape
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + tag + data
                + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """img: (H, W, 3) float in [0,1] or uint8."""
    with open(path, "wb") as f:
        f.write(png_bytes(img))


# ----------------------------------------------------------------------
# GIF (animated, global 256-color palette)
# ----------------------------------------------------------------------

def _palette() -> np.ndarray:
    """6x7x6 RGB cube (252 colors) + 4 grays = 256."""
    rs = np.linspace(0, 255, 6)
    gs = np.linspace(0, 255, 7)
    bs = np.linspace(0, 255, 6)
    cube = np.array([(r, g, b) for r in rs for g in gs for b in bs])
    grays = np.array([(40, 40, 40), (120, 120, 120),
                      (200, 200, 200), (255, 255, 255)])
    return np.concatenate([cube, grays]).astype(np.uint8)


def _quantize(arr: np.ndarray) -> np.ndarray:
    """uint8 (H,W,3) -> palette indices into the 6x7x6 cube."""
    r = np.rint(arr[..., 0] / 255.0 * 5).astype(np.int32)
    g = np.rint(arr[..., 1] / 255.0 * 6).astype(np.int32)
    b = np.rint(arr[..., 2] / 255.0 * 5).astype(np.int32)
    return ((r * 7 + g) * 6 + b).astype(np.uint8)


def _quantize_lut(arr: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Nearest-palette quantisation via a 32^3 RGB lattice LUT (exact to
    within the 8-level lattice spacing) — lets callers supply
    content-derived palettes (e.g. the renderer's density ramp)."""
    lat = (np.arange(32) * 255 / 31.0)
    grid = np.stack(np.meshgrid(lat, lat, lat, indexing="ij"), -1)  # 32^3,3
    d = np.linalg.norm(grid.reshape(-1, 1, 3)
                       - palette.astype(np.float64)[None], axis=-1)
    lut = np.argmin(d, axis=1).astype(np.uint8).reshape(32, 32, 32)
    q = np.minimum(arr >> 3, 31)
    return lut[q[..., 0], q[..., 1], q[..., 2]]


def _lzw_encode(indices: np.ndarray, min_code_size: int = 8) -> bytes:
    """GIF-flavour LZW."""
    clear = 1 << min_code_size
    end = clear + 1
    next_code = end + 1
    code_size = min_code_size + 1
    table = {bytes([i]): i for i in range(clear)}

    out = bytearray()
    cur = 0
    nbits = 0

    def emit(code: int):
        nonlocal cur, nbits
        cur |= code << nbits
        nbits += code_size
        while nbits >= 8:
            out.append(cur & 0xFF)
            cur >>= 8
            nbits -= 8

    emit(clear)
    data = indices.tobytes()
    s = b""
    for ch in data:
        sc = s + bytes([ch])
        if sc in table:
            s = sc
        else:
            emit(table[s])
            table[sc] = next_code
            next_code += 1
            if next_code > (1 << code_size) and code_size < 12:
                code_size += 1
            elif next_code >= 4096:
                emit(clear)
                table = {bytes([i]): i for i in range(clear)}
                next_code = end + 1
                code_size = min_code_size + 1
            s = bytes([ch])
    if s:
        emit(table[s])
    emit(end)
    if nbits:
        out.append(cur & 0xFF)
    return bytes(out)


def write_gif(path: str, frames: Sequence[np.ndarray],
              fps: float = 25.0, palette: np.ndarray | None = None) -> None:
    """frames: list of (H, W, 3) float [0,1] or uint8 images.

    palette: optional (256, 3) uint8 custom palette (e.g.
    ``render.renderer_palette()``); default is the generic 6x7x6 cube.
    Both paths use the native C++ encoder when available (custom palettes
    quantise through the same 32^3 LUT scheme as the Python fallback)."""
    try:
        from ..runtime import native  # C++ fast path
        if native.available():
            native.write_gif(path, [to_uint8(f) for f in frames], fps,
                             palette=palette)
            return
    except Exception:
        pass
    _write_gif_py(path, frames, fps, palette)


def _write_gif_py(path: str, frames: Sequence[np.ndarray], fps: float,
                  palette: np.ndarray | None = None) -> None:
    assert len(frames) > 0
    h, w = frames[0].shape[:2]
    delay = max(2, int(round(100.0 / fps)))
    pal = _palette() if palette is None else np.asarray(palette, np.uint8)
    assert pal.shape == (256, 3)

    buf = bytearray()
    buf += b"GIF89a"
    buf += struct.pack("<HHBBB", w, h, 0xF7, 0, 0)  # global table, 256 colors
    buf += pal.tobytes()
    # loop forever
    buf += b"\x21\xFF\x0BNETSCAPE2.0\x03\x01\x00\x00\x00"
    for fr in frames:
        arr = fr if fr.dtype == np.uint8 else to_uint8(fr)
        idx = _quantize(arr) if palette is None else _quantize_lut(arr, pal)
        buf += b"\x21\xF9\x04\x04" + struct.pack("<H", delay) + b"\x00\x00"
        buf += b"\x2C" + struct.pack("<HHHHB", 0, 0, w, h, 0)
        buf += bytes([8])  # LZW min code size
        data = _lzw_encode(idx.ravel())
        for i in range(0, len(data), 255):
            block = data[i:i + 255]
            buf += bytes([len(block)]) + block
        buf += b"\x00"
    buf += b"\x3B"
    with open(path, "wb") as f:
        f.write(bytes(buf))
