"""Model export for serving, the port of
``supervised_dispnet_tpu/utils/export.py``: the forward pass as a
``torch.export`` program saved with ``torch.export.save`` (in place of the
JAX package's StableHLO artifact) and loaded with ``load_forward``.

``export_forward`` exports a disparity network's finest output (FCRN's
depth), for a fixed batch size or ``"dynamic"`` (``torch.export.Dim``: one
program serves any batch; height and width stay fixed). With
``int8_ranges`` (``ops/quant.py::calibrate_conv_ranges``) it exports the
int8 twin (``ops/quant.py::QuantizedModel``): the program stores the baked
int8 weights and their scales, not the float32 kernels of the quantized
convs, and is smaller. ``export_pose_forward`` exports the pose net:
(tgt (B, H, W, 3), refs (B, R, H, W, 3)) -> (B, R, 6) poses.

Unlike the JAX artifact, which runs without the model code, an int8
program calls the custom op ``torch.ops.sdtpu.int8_conv``: the process that
loads it must ``import supervised_dispnet_tpu_torch.ops.cuda.int8_conv``
first (``load_forward`` does), which registers the op's kernel for the card
and its plain version for the CPU. A float program needs nothing of the
port.
"""

from __future__ import annotations

from pathlib import Path

import torch
from torch import nn


class _Finest(nn.Module):
    """A network's finest output: the first of a list, or the one map."""

    def __init__(self, net: nn.Module):
        super().__init__()
        self.net = net

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.net(x)
        return out[0] if isinstance(out, (list, tuple)) else out


class _Pose(nn.Module):
    def __init__(self, net: nn.Module, nb_ref_imgs: int):
        super().__init__()
        self.net = net
        self.nb_ref_imgs = nb_ref_imgs

    def forward(self, tgt: torch.Tensor, refs: torch.Tensor) -> torch.Tensor:
        out = self.net(tgt, [refs[:, i] for i in range(self.nb_ref_imgs)])
        return out[1] if isinstance(out, tuple) else out  # PoseExpNet: (masks, pose)


def _batch_dim(batch_size: int | str, names: list[str]) -> tuple[int, dict | None]:
    if batch_size == "dynamic":
        b = torch.export.Dim("b", min=1, max=4096)
        return 2, {n: {0: b} for n in names}
    return int(batch_size), None


def _device(model: nn.Module) -> torch.device:
    return next(model.parameters()).device


def export_forward(model: nn.Module, path: str | Path, batch_size: int | str = 1,
                   img_height: int = 128, img_width: int = 416,
                   int8_ranges: dict[str, float] | None = None) -> None:
    """Save ``model``'s eval forward (B, H, W, 3) -> its finest output, on
    the model's device, as a ``torch.export`` program at ``path``. With
    ``int8_ranges`` the int8 twin's forward, with the baked int8 weights."""
    model = model.eval()
    net = model
    if int8_ranges is not None:
        from supervised_dispnet_tpu_torch.ops.quant import QuantizedModel

        net = QuantizedModel(model, int8_ranges).to(_device(model))
    b, dims = _batch_dim(batch_size, ["x"])
    x = torch.zeros(b, img_height, img_width, 3, device=_device(model))
    with torch.no_grad():
        ep = torch.export.export(_Finest(net), (x,), dynamic_shapes=dims)
    torch.export.save(ep, str(path))


def export_pose_forward(model: nn.Module, path: str | Path, nb_ref_imgs: int = 2,
                        batch_size: int | str = 1, img_height: int = 128,
                        img_width: int = 416) -> None:
    """Save the pose net's forward (tgt (B, H, W, 3), refs (B, R, H, W, 3))
    -> (B, R, 6) target-to-reference poses; ``batch_size`` as
    ``export_forward``'s."""
    model = model.eval()
    b, dims = _batch_dim(batch_size, ["tgt", "refs"])
    dev = _device(model)
    tgt = torch.zeros(b, img_height, img_width, 3, device=dev)
    refs = torch.zeros(b, nb_ref_imgs, img_height, img_width, 3, device=dev)
    with torch.no_grad():
        ep = torch.export.export(_Pose(model, nb_ref_imgs), (tgt, refs), dynamic_shapes=dims)
    torch.export.save(ep, str(path))


def load_forward(path: str | Path):
    """Load a saved program; returns a callable with the exported signature
    (disparity: (x) -> finest output; pose: (tgt, refs) -> poses). Imports
    the int8 op's module, which an int8 program calls, and sets the card's
    float math to full fp32 (``utils/device.py::set_fp32_math``), as the
    port's entry points do: with PyTorch's default, cuDNN runs the
    program's float convolutions in TF32."""
    import supervised_dispnet_tpu_torch.ops.cuda.int8_conv  # noqa: F401  (registers the op)
    from supervised_dispnet_tpu_torch.utils.device import set_fp32_math

    set_fp32_math()
    return torch.export.load(str(path)).module()
