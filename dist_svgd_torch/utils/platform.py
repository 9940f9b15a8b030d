"""Device resolution for the PyTorch port.

The port's entry points run on the card unless the caller asks for the CPU:
``resolve_device(None)`` is ``cuda`` and raises where CUDA is missing — it
never carries on quietly on the CPU.  Tests pass ``device="cpu"``.

Resolving a device also pins full-f32 matmuls: the JAX reference runs its φ
contractions at ``Precision.HIGHEST`` (``dist_svgd_tpu/ops/svgd.py:phi``), and
Hopper's TF32 tensor-core path would silently keep only ~3 decimal digits of
the distance and drive products.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def pin_full_f32() -> None:
    """Turn TF32 off for CUDA matmuls and cuDNN convolutions (process-wide
    torch settings — the port's float32 means float32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` → ``cuda``; a named device is taken as given.  Raises
    ``RuntimeError`` when a CUDA device is asked for (explicitly or by
    default) and ``torch.cuda.is_available()`` is false."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the card by default; "
            "pass device='cpu' to run the plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    pin_full_f32()
    return dev
