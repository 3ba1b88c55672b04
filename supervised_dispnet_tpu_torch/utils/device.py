"""Device selection and the float32 math mode for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device an entry point runs on. The card is the default; a CUDA
    request without a card raises rather than falling back to the CPU, which
    runs only when the caller asks for it."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' (CLI: --device cpu) to run on the CPU")
    return dev


def set_fp32_math(tf32: bool = False) -> None:
    """Set how the card computes float32 convolutions (cuDNN) and matrix
    products: in full float32 by default, as the reference computes and the
    cross-checks hold; in TF32 on the tensor cores with ``tf32=True``.
    PyTorch's own default runs cuDNN convolutions in TF32. The flags are
    process-wide and do nothing on the CPU."""
    torch.backends.cudnn.allow_tf32 = tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
