"""Image output (PNG, PPM) and golden-image helpers (port of hagrid_tpu/io/image.py).

numpy only; the same functions as the reference module, so hashes taken
with either package compare directly.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np


def to_u8(img: np.ndarray) -> np.ndarray:
    """f32[H,W,3] in [0,1] -> u8[H,W,3] with gamma 2.2."""
    img = np.clip(np.asarray(img, np.float32), 0.0, 1.0)
    return (np.power(img, 1.0 / 2.2) * 255.0 + 0.5).astype(np.uint8)


def write_png(path: str, img: np.ndarray):
    """img: u8[H,W,3] or f32[H,W,3] in [0,1]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_u8(img)
    h, w, _ = img.shape
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(tag: bytes, payload: bytes) -> bytes:
        out = struct.pack(">I", len(payload)) + tag + payload
        return out + struct.pack(">I", zlib.crc32(tag + payload))

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n")
        fh.write(chunk(b"IHDR", ihdr))
        fh.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        fh.write(chunk(b"IEND", b""))


def write_ppm(path: str, img: np.ndarray):
    """Binary PPM (P6): img u8[H,W,3] or f32[H,W,3] in [0,1]."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        img = to_u8(img)
    h, w, _ = img.shape
    with open(path, "wb") as fh:
        fh.write(f"P6\n{w} {h}\n255\n".encode())
        fh.write(img.tobytes())


def shade_eyelight(hits_tri, hits_t, tri_n, ray_dir, width, height):
    """Eye-light shading: brightness = |cos(normal, ray)|.

    hits_tri i32[N], tri_n f32[T,3] unnormalized normals, ray_dir f32[N,3],
    all numpy. Returns f32[H,W,3]."""
    n = tri_n[np.maximum(hits_tri, 0)]
    n = n / (np.linalg.norm(n, axis=-1, keepdims=True) + 1e-20)
    c = np.abs(np.sum(n * np.asarray(ray_dir), axis=-1))
    c = np.where(hits_tri >= 0, c, 0.0).astype(np.float32)
    img = np.repeat(c[:, None], 3, axis=1)
    return img.reshape(height, width, 3)


def _pool(lum: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Average-pool f32[H,W] to f32[rows,cols] over near-equal strips."""
    h, w = lum.shape
    if h < rows or w < cols:
        raise ValueError(f"image {h}x{w} is smaller than the "
                         f"{rows}x{cols} hash grid")
    rb = np.floor(np.linspace(0, h, rows + 1)).astype(int)
    cb = np.floor(np.linspace(0, w, cols + 1)).astype(int)
    r = np.add.reduceat(lum, rb[:-1], axis=0) \
        / np.maximum(np.diff(rb), 1)[:, None]
    return np.add.reduceat(r, cb[:-1], axis=1) \
        / np.maximum(np.diff(cb), 1)[None, :]


def dhash(img: np.ndarray, hash_size: int = 8) -> str:
    """64-bit difference hash of an image: average-pool the luminance to
    (hash_size, hash_size+1) and keep the sign of each horizontal
    gradient. Float jitter flips a bit or two; structural changes flip
    many. Compare with `hamming` and a small tolerance."""
    img = np.asarray(img, np.float32)
    lum = img.mean(axis=2) if img.ndim == 3 else img
    p = _pool(lum, hash_size, hash_size + 1)
    bits = (p[:, 1:] > p[:, :-1]).astype(np.uint8).reshape(-1)
    return np.packbits(bits).tobytes().hex()


def hamming(h1: str, h2: str) -> int:
    """Bit distance between two dhash hex strings of equal length."""
    if len(h1) != len(h2):
        raise ValueError(f"hash lengths differ: {len(h1)} vs {len(h2)}")
    a = np.frombuffer(bytes.fromhex(h1), np.uint8)
    b = np.frombuffer(bytes.fromhex(h2), np.uint8)
    return int(np.unpackbits(a ^ b).sum())
