"""Image IO — PNG read/write for renders, heightmaps and material maps.

Replaces the reference's present path (fullscreen-triangle draw of the
framebuffer texture, ``quad.vert``/``quad.frag``) and its STB image loads
(``Octree.java:200-227``, ``MaterialTextureGenerator.java:66-96``).
Writing needs only the standard library (zlib + struct); reading decodes
arbitrary PNGs through Pillow, imported on first use.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) gray or (H, W, 3) RGB uint8 array -> PNG file bytes."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"expected (H, W) or (H, W, 3) uint8, got "
                         f"{img.shape}")
    h, w = img.shape[:2]
    color_type = 2 if img.ndim == 3 else 0
    # filter type 0 (None) on every scanline
    raw = np.concatenate([np.zeros((h, 1), np.uint8),
                          img.reshape(h, -1)], axis=1).tobytes()
    ihdr = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


def write_png(path: str, color: np.ndarray, flip: bool = True) -> None:
    """Write an (H, W, 3) float image in [0,1].  ``flip`` converts from GL
    row order (row 0 = bottom) to PNG row order (row 0 = top)."""
    img = np.asarray(color)
    img = np.nan_to_num(img, nan=1.0, posinf=1.0, neginf=0.0)
    img = (np.clip(img, 0.0, 1.0) * 255.0).astype(np.uint8)
    if flip:
        img = img[::-1]
    with open(path, "wb") as f:
        f.write(encode_png(img))


def _open_image(path: str):
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f"reading {path!r} needs Pillow (PIL), which is "
                          "not installed; PNG writing needs no Pillow") from e
    return Image.open(path)


def read_png(path: str) -> np.ndarray:
    """(H, W) or (H, W, C) uint8/uint16 array."""
    return np.asarray(_open_image(path))


def read_heightmap(path: str) -> np.ndarray:
    """16-bit single-channel heightmap like stbi_load_16 (Octree.java:208)."""
    arr = np.asarray(_open_image(path))
    if arr.ndim == 3:
        arr = arr[..., 0]
    if arr.dtype == np.uint8:
        arr = arr.astype(np.uint16) * 257
    return arr.astype(np.uint16)
