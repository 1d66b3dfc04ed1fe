"""Minimal dependency-free PNG encoder (8-bit RGB/RGBA, zlib only)."""

from __future__ import annotations

import struct
import zlib

import numpy as np


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def encode_png(rgb_u8: np.ndarray) -> bytes:
    """The PNG file of an [H, W, 3|4] uint8 image: one IDAT of filter-0 rows
    deflated at zlib level 6."""
    img = np.asarray(rgb_u8)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError(f"expected an [H, W, 3|4] uint8 image, got {img.dtype} "
                         f"{tuple(img.shape)}")
    h, w, c = img.shape
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    # each row behind its filter byte 0 (None)
    raw = np.zeros((h, 1 + w * c), dtype=np.uint8)
    raw[:, 1:] = img.reshape(h, w * c)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path, image: np.ndarray) -> None:
    """Write an [H, W, 3|4] (or [H, W] gray) uint8 or float (0..1) image as
    PNG."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if img.ndim == 2:
        img = np.repeat(img[:, :, None], 3, axis=2)
    with open(path, "wb") as f:
        f.write(encode_png(img))
