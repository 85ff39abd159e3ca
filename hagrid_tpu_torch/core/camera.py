"""Pinhole camera and primary-ray generation (port of
hagrid_tpu/core/camera.py).

Rays come out as one flat SoA batch, in scanline order or in 32x32
image blocks Morton-ordered within the block (the order the packet
tracer wants: every power-of-two run of rays is a square-ish pixel
rectangle, so tile and quarter-tile frusta stay narrow).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .types import Rays


@dataclasses.dataclass(frozen=True)
class Camera:
    eye: tuple
    center: tuple
    up: tuple = (0.0, 1.0, 0.0)
    fov_deg: float = 60.0

    def basis(self):
        eye = np.asarray(self.eye, np.float32)
        fwd = np.asarray(self.center, np.float32) - eye
        fwd = fwd / np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(self.up, np.float32))
        right = right / np.linalg.norm(right)
        up = np.cross(right, fwd)
        return eye, fwd, right, up


def _morton_deinterleave(within, bits: int = 5):
    """Split a 2*bits Morton code into (x, y). Works on numpy arrays and
    integer tensors alike."""
    x = within * 0
    y = within * 0
    for k in range(bits):
        x = x | (((within >> (2 * k)) & 1) << k)
        y = y | (((within >> (2 * k + 1)) & 1) << k)
    return x, y


def block_index(width: int, height: int, block: int = 32) -> np.ndarray:
    """Pixel index (y * width + x) of ray i in block order: the host-side
    inverse map for reassembling images from block-ordered hit arrays."""
    bpr = width // block
    i = np.arange(width * height)
    bi, within = i // (block * block), i % (block * block)
    wx, wy = _morton_deinterleave(within)
    gx = (bi % bpr) * block + wx
    gy = (bi // bpr) * block + wy
    return gy * width + gx


def primary_rays(cam: Camera, width: int, height: int, jitter=None,
                 order: str = "scanline", device=None) -> Rays:
    """width*height primary rays on `device`.

    order: "scanline" (y-major) or "block" (32x32 tiles, Morton within
    the tile; reassemble images with `block_index`). Falls back to
    scanline when the size is not a multiple of 32. jitter: optional
    f32[H*W, 2] subpixel offsets in [0, 1); defaults to pixel centers.
    """
    eye, fwd, right, up = cam.basis()
    # f32 constants, as the reference rounds them.
    tan_half = float(np.float32(np.tan(np.radians(cam.fov_deg) * 0.5)))
    aspect = float(np.float32(width / height))
    f32 = dict(dtype=torch.float32, device=device)

    if order == "block" and width % 32 == 0 and height % 32 == 0:
        b = 32
        bpr = width // b
        i = torch.arange(width * height, dtype=torch.int32, device=device)
        bi = i // (b * b)
        within = i % (b * b)
        wx, wy = _morton_deinterleave(within)
        gx = ((bi % bpr) * b + wx).to(torch.float32)
        gy = ((bi // bpr) * b + wy).to(torch.float32)
    else:
        px = torch.arange(width, **f32)
        py = torch.arange(height, **f32)
        gy, gx = torch.meshgrid(py, px, indexing="ij")  # [H, W]
        gx = gx.reshape(-1)
        gy = gy.reshape(-1)
    if jitter is None:
        ox = oy = 0.5
    else:
        jitter = torch.as_tensor(jitter, **f32)
        ox = jitter[:, 0]
        oy = jitter[:, 1]
    # NDC in [-1, 1], y flipped so row 0 is the top of the image.
    ndc_x = (2.0 * (gx + ox) / width - 1.0) * tan_half * aspect
    ndc_y = (1.0 - 2.0 * (gy + oy) / height) * tan_half

    d = (ndc_x[:, None] * torch.as_tensor(right, **f32)
         + ndc_y[:, None] * torch.as_tensor(up, **f32)
         + torch.as_tensor(fwd, **f32))
    d = d / torch.sqrt((d * d).sum(dim=-1, keepdim=True))
    org = torch.as_tensor(eye, **f32).expand(d.shape).contiguous()
    return Rays.make(org, d)
