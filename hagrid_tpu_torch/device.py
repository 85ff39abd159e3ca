"""Where the port's entry points put their tensors when the caller names no
device: on the card. There is no CPU fallback; the CPU is used only when a
caller asks for it (`device="cpu"`, as the tests do) or hands in CPU
tensors.
"""

from __future__ import annotations

import torch

# Device constants made from host values, by (values, dtype, device).
_consts: dict = {}


def default_device() -> torch.device:
    """The CUDA device; raises when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "hagrid_tpu_torch runs on an NVIDIA GPU by default and "
            "torch.cuda.is_available() is false; pass device='cpu' to run "
            "the plain PyTorch versions on the CPU")
    return torch.device("cuda")


def device_name(device) -> str:
    """What a measurement names its device: the card's name, or "cpu"."""
    device = torch.device(device)
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")


def resolve(device=None, like=None) -> torch.device:
    """`device` if given, else the device of the tensor `like`, else the
    card."""
    if device is not None:
        return torch.device(device)
    if torch.is_tensor(like):
        return like.device
    return default_device()


def const(values, dtype, device) -> torch.Tensor:
    """torch.tensor(values) on `device`, made once per (values, dtype,
    device) and shared: a copy from the host synchronises, which a
    capture forbids, so the warm-up run before a capture makes it and
    the capture reads it. values: nested tuples; never write to the
    result."""
    key = (values, dtype, torch.device(device))
    t = _consts.get(key)
    if t is None:
        t = _consts[key] = torch.tensor(values, dtype=dtype, device=device)
    return t
