"""On-device augmentation, the port of
``supervised_dispnet_tpu/data/augment.py``.

Random horizontal flip and scale-crop (scale in [1, 1.15], cropped back to
the original size, intrinsics rescaled) collapse into one affine,
axis-aligned coordinate map, so the bilinear resample is separable: per
sample two tent-weight matrix products (A_y @ img @ A_x^T). Sparse GT depth
rides the same map with nearest taps (bilinear would bleed zeros into the
LiDAR points). Then brightness, contrast and saturation jitter, shared
across a snippet's frames, and normalisation.

Randomness comes from a ``torch.Generator``; ``draws=`` takes the random
numbers from the caller instead (tests pass the JAX package's draws).
"""

from __future__ import annotations

import dataclasses

import torch

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HALF_MEAN = (0.5, 0.5, 0.5)
HALF_STD = (0.5, 0.5, 0.5)


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    flip: bool = True
    scale_crop: bool = True
    max_scale: float = 1.15
    color_jitter: bool = True
    brightness: float = 0.2
    contrast: float = 0.2
    saturation: float = 0.2
    hue: float = 0.0  # hue jitter is not ported yet: > 0 raises
    mean: tuple[float, float, float] = HALF_MEAN
    std: tuple[float, float, float] = HALF_STD


def draw_augment(B: int, H: int, W: int, config: AugmentConfig,
                 generator: torch.Generator | None = None,
                 device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Per-sample random numbers of one augmentation, each of shape (B,):
    scale_x, scale_y in [1, max_scale); crop offsets ox in [0, (scale_x-1)W)
    and oy likewise; flip (bool); and, with color jitter, the brightness,
    contrast and saturation factors in [1 - a, 1 + a)."""
    def u(lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
        return lo + (hi - lo) * torch.rand(B, generator=generator, device=device)

    if config.scale_crop:
        sx, sy = u(1.0, config.max_scale), u(1.0, config.max_scale)
    else:
        sx = sy = torch.ones(B, device=device)
    draws = {"scale_x": sx, "scale_y": sy,
             "ox": u() * (sx - 1.0) * W, "oy": u() * (sy - 1.0) * H,
             "flip": (u() < 0.5) if config.flip
             else torch.zeros(B, dtype=torch.bool, device=device)}
    if config.color_jitter:
        draws["brightness"] = u(1.0 - config.brightness, 1.0 + config.brightness)
        draws["contrast"] = u(1.0 - config.contrast, 1.0 + config.contrast)
        draws["saturation"] = u(1.0 - config.saturation, 1.0 + config.saturation)
    return draws


def augment_batch(
    imgs: torch.Tensor,
    intrinsics: torch.Tensor,
    depth: torch.Tensor | None = None,
    config: AugmentConfig = AugmentConfig(),
    generator: torch.Generator | None = None,
    draws: dict[str, torch.Tensor] | None = None,
):
    """Augment a batch of snippets.

    imgs: (B, S, H, W, 3) float in [0, 1]; intrinsics: (B, 3, 3); depth:
    optional (B, H, W) sparse GT (zeros = missing). Returns (imgs,
    intrinsics[, depth]) with imgs normalised; same shapes.
    """
    if config.hue > 0:
        raise NotImplementedError("hue jitter is not ported yet; see ROADMAP.md")
    B, S, H, W, _ = imgs.shape
    dev, f32 = imgs.device, torch.float32
    if draws is None:
        draws = draw_augment(B, H, W, config, generator, dev)
    sx, sy = draws["scale_x"], draws["scale_y"]
    ox, oy, flip = draws["ox"], draws["oy"], draws["flip"]

    # output pixel (i, j) samples the source at ((oy + i) / sy, (ox + j) / sx);
    # flip mirrors the output x axis first
    jj = torch.arange(W, dtype=f32, device=dev).expand(B, W)
    ii = torch.arange(H, dtype=f32, device=dev).expand(B, H)
    jj = torch.where(flip[:, None], (W - 1.0) - jj, jj)
    xs = ((jj + ox[:, None]) / sx[:, None]).clamp(0.0, W - 1)  # (B, W)
    ys = ((ii + oy[:, None]) / sy[:, None]).clamp(0.0, H - 1)  # (B, H)
    h_iota = torch.arange(H, dtype=f32, device=dev).view(1, 1, H)
    w_iota = torch.arange(W, dtype=f32, device=dev).view(1, 1, W)
    Ay = (1.0 - (ys[:, :, None] - h_iota).abs()).clamp(min=0.0)  # (B, H, H)
    Ax = (1.0 - (xs[:, :, None] - w_iota).abs()).clamp(min=0.0)  # (B, W, W)
    out = torch.einsum("bih,bshwc->bsiwc", Ay, imgs)
    out = torch.einsum("bjw,bsiwc->bsijc", Ax, out)

    # intrinsics: scale, then crop, then flip
    fx = intrinsics[:, 0, 0] * sx
    fy = intrinsics[:, 1, 1] * sy
    cx = intrinsics[:, 0, 2] * sx - ox
    cy = intrinsics[:, 1, 2] * sy - oy
    cx = torch.where(flip, (W - 1.0) - cx, cx)
    zeros, ones = torch.zeros_like(fx), torch.ones_like(fx)
    new_K = torch.stack([fx, zeros, cx, zeros, fy, cy, zeros, zeros, ones],
                        dim=-1).reshape(B, 3, 3)

    if config.color_jitter:
        b, c, s = (draws[k].view(B, 1, 1, 1, 1)
                   for k in ("brightness", "contrast", "saturation"))
        out = (out * b).clamp(0.0, 1.0)
        mean_px = out.mean(dim=(2, 3, 4), keepdim=True)
        out = ((out - mean_px) * c + mean_px).clamp(0.0, 1.0)
        gray = 0.299 * out[..., 0:1] + 0.587 * out[..., 1:2] + 0.114 * out[..., 2:3]
        out = ((out - gray) * s + gray).clamp(0.0, 1.0)
    out = normalize_images(out, config.mean, config.std)

    if depth is None:
        return out, new_K
    # nearest taps as one-hot selector products; scale >= 1 keeps them in bounds
    Ny = (ys.round()[:, :, None] == h_iota).to(f32)  # (B, H, H)
    Nx = (xs.round()[:, :, None] == w_iota).to(f32)  # (B, W, W)
    d = torch.einsum("bih,bhw->biw", Ny, depth)
    d = torch.einsum("bjw,biw->bij", Nx, d)
    return out, new_K, d


def normalize_images(imgs: torch.Tensor,
                     mean: tuple[float, float, float] = HALF_MEAN,
                     std: tuple[float, float, float] = HALF_STD) -> torch.Tensor:
    """(x - mean) / std over the last (channel) axis."""
    m = torch.tensor(mean, dtype=torch.float32, device=imgs.device)
    s = torch.tensor(std, dtype=torch.float32, device=imgs.device)
    return (imgs - m) / s
