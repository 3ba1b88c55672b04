"""Visualisation helpers, the port of ``supervised_dispnet_tpu/utils/viz.py``
(reference: ``utils.py::tensor2array``): colour-mapped disparity and depth
images, written with the port's own PNG encoder."""

from __future__ import annotations

import numpy as np

from supervised_dispnet_tpu_torch.utils.image_io import write_png


def tensor2array(arr: np.ndarray, max_value: float | None = None,
                 colormap: str = "magma") -> np.ndarray:
    """(H, W) scalar map -> (H, W, 3) float RGB in [0, 1] through
    matplotlib's colormap where matplotlib imports, grey where it does not;
    (H, W, 3) images are denormalised from [-1, 1]."""
    arr = np.asarray(arr)
    if arr.ndim == 2 or (arr.ndim == 3 and arr.shape[-1] == 1):
        arr = arr.reshape(arr.shape[0], arr.shape[1])
        if max_value is None:
            max_value = float(arr.max()) or 1.0
        norm = np.clip(arr / max_value, 0, 1)
        try:
            import matplotlib

            rgba = matplotlib.colormaps[colormap](norm)
        except (ImportError, KeyError):
            rgba = np.stack([norm, norm, norm, np.ones_like(norm)], -1)
        return rgba[..., :3].astype(np.float32)
    # image: assume normalized with 0.5/0.5
    return np.clip(arr * 0.5 + 0.5, 0, 1).astype(np.float32)


def save_depth_png(path, depth: np.ndarray, max_value: float | None = None) -> None:
    """Write ``tensor2array(depth, max_value)`` as an 8-bit RGB PNG."""
    write_png(path, (tensor2array(depth, max_value) * 255).astype(np.uint8))
