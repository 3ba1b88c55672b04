"""Depth as classification: binned-depth cross-entropy and the soft decode.

The port of ``supervised_dispnet_tpu/losses/classification.py``. Logits are
(B, H, W, K) over K depth bins; ``gt_depth`` and ``mask`` are (B, H, W).
The CE goes through the CUDA kernels (``ops/cuda/classification.py``) for
CUDA tensors and through ``depth_classification_loss_plain`` for CPU
tensors.
"""

from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable, Sequence

import torch

from supervised_dispnet_tpu_torch.ops.cuda.classification import cross_entropy_cuda
from supervised_dispnet_tpu_torch.ops.resize import resize_bilinear


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float32 0-d tensor on ``like``'s device: a constant that enters a
    float32 op as JAX's weakly typed Python scalars do, rounded to float32
    once. As a tensor it also keeps a division a true division on the card,
    where a division by a Python scalar may become a product with its
    reciprocal."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


@dataclasses.dataclass(frozen=True)
class DepthBins:
    """Static depth discretisation: ``num_bins`` bins over [min_depth,
    max_depth], spaced uniformly in depth (``linear``), in log depth
    (``log``, the default) or in disparity (``inverse``)."""

    num_bins: int = 64
    min_depth: float = 1.0
    max_depth: float = 80.0
    spacing: str = "log"  # 'linear' | 'log' | 'inverse'

    def edges(self, device: str | torch.device = "cpu") -> torch.Tensor:
        """(num_bins + 1,) float32 bin edges in depth, increasing."""
        n, lo, hi = self.num_bins, self.min_depth, self.max_depth
        if self.spacing == "linear":
            e = torch.linspace(lo, hi, n + 1, dtype=torch.float64)
        elif self.spacing == "log":
            e = torch.linspace(math.log(lo), math.log(hi), n + 1, dtype=torch.float64).exp()
        elif self.spacing == "inverse":
            e = (1.0 / torch.linspace(1.0 / hi, 1.0 / lo, n + 1, dtype=torch.float64)).flip(0)
        else:
            raise ValueError(f"unknown spacing: {self.spacing!r}")
        return e.to(torch.float32).to(device)

    def centers(self, device: str | torch.device = "cpu") -> torch.Tensor:
        """(num_bins,) float32 depth of each bin: the geometric mid of its
        edges for ``log``, the arithmetic mid otherwise."""
        e = self.edges(device)
        if self.spacing == "log":
            return torch.sqrt(e[:-1] * e[1:])
        return 0.5 * (e[:-1] + e[1:])

    def depth_to_index(self, depth: torch.Tensor) -> torch.Tensor:
        """Metric depth -> int32 bin index, clipped to [0, num_bins - 1]. The
        float32 operations and their order are the JAX package's, so the
        labels are the same."""
        d = depth.to(torch.float32).clamp(self.min_depth, self.max_depth)
        n = self.num_bins
        if self.spacing == "linear":
            t = (d - _f32(self.min_depth, d)) / _f32(self.max_depth - self.min_depth, d)
        elif self.spacing == "log":
            log_lo, log_hi = math.log(self.min_depth), math.log(self.max_depth)
            t = (torch.log(d) - _f32(log_lo, d)) / _f32(log_hi - log_lo, d)
        elif self.spacing == "inverse":
            lo, hi = 1.0 / self.max_depth, 1.0 / self.min_depth
            t = 1.0 - (1.0 / d - _f32(lo, d)) / _f32(hi - lo, d)
        else:
            raise ValueError(f"unknown spacing: {self.spacing!r}")
        return torch.floor(t * n).to(torch.int32).clamp(0, n - 1)


def _labels(gt_depth: torch.Tensor, bins: DepthBins | None,
            labels: torch.Tensor | None) -> torch.Tensor:
    if labels is None:
        if bins is None:
            raise ValueError("give bins (to label gt_depth) or labels")
        labels = bins.depth_to_index(gt_depth)
    return labels


def depth_classification_loss_plain(logits: torch.Tensor, gt_depth: torch.Tensor | None,
                                    mask: torch.Tensor, bins: DepthBins | None = None,
                                    labels: torch.Tensor | None = None) -> torch.Tensor:
    """Masked per-pixel cross-entropy over the depth bins, in plain PyTorch:
    log-softmax, the label's entry, a masked mean over max(sum(mask), 1).
    The reference the CUDA kernels are held against, and the version that
    runs on the CPU. ``labels`` (int, ``bins.depth_to_index(gt_depth)``)
    may be given instead of ``gt_depth`` and ``bins``."""
    labels = _labels(gt_depth, bins, labels)
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]
    m = mask.to(torch.float32)
    return (nll * m).sum() / m.sum().clamp(min=1.0)


def depth_classification_loss(logits: torch.Tensor, gt_depth: torch.Tensor | None,
                              mask: torch.Tensor, bins: DepthBins | None = None,
                              labels: torch.Tensor | None = None) -> torch.Tensor:
    """The masked CE of ``depth_classification_loss_plain``: through the
    CUDA kernels for CUDA tensors (``ops/cuda/classification.py``), the
    plain version for CPU tensors."""
    if logits.device.type == "cuda":
        return cross_entropy_cuda(logits, _labels(gt_depth, bins, labels), mask)
    if logits.device.type == "cpu":
        return depth_classification_loss_plain(logits, gt_depth, mask, bins, labels)
    raise ValueError(f"depth_classification_loss: no implementation for device "
                     f"{logits.device}")


def multiscale_classification_loss(
    logits_list: Sequence[torch.Tensor],
    gt_depth: torch.Tensor,
    mask: torch.Tensor,
    bins: DepthBins,
    ce_fn: Callable = depth_classification_loss,
    weights: tuple[float, ...] = (1.0, 0.5, 0.25, 0.125),
) -> torch.Tensor:
    """Weighted sum of the CE over the scales' (B, h, w, K) logits, each
    bilinearly upsampled to GT resolution first (the sparse GT cannot be
    downsampled). The labels depend on the GT only, so they are computed
    once for all scales."""
    H, W = gt_depth.shape[1], gt_depth.shape[2]
    labels = bins.depth_to_index(gt_depth)
    total = torch.zeros((), dtype=torch.float32, device=gt_depth.device)
    for logits, w in zip(logits_list, weights):
        total = total + w * ce_fn(resize_bilinear(logits, H, W), None, mask,
                                  labels=labels)
    return total


def logits_to_depth(logits: torch.Tensor, bins: DepthBins) -> torch.Tensor:
    """Soft-weighted-sum decode: depth = sum_k softmax(logits)_k * center_k,
    (B, H, W, K) -> (B, H, W)."""
    p = torch.softmax(logits.to(torch.float32), dim=-1)
    return p @ bins.centers(logits.device)
