"""Differentiable camera geometry: pose parameterisations and the inverse
warp. The port of ``supervised_dispnet_tpu/ops/warp.py``.

Conventions, as in the JAX package:
- depth: (B, H, W) metric depth of the target view;
- pose: (B, 6) = [tx, ty, tz, r1, r2, r3], rotation as Euler angles
  (R = Rx @ Ry @ Rz) or the imaginary part of a quaternion with w = 1 before
  normalisation;
- intrinsics: (B, 3, 3) pinhole K;
- pixel (0, 0) is the center of the top-left pixel. ``cam2pixel`` returns
  pixel coordinates and the sampler takes them as they are (no [-1, 1]
  round trip).

The 3x3 geometry is plain float32 PyTorch (``warp_coords``). The sample
(``sample``; ``sample_many`` for a group of them in one launch each way)
goes through the CUDA kernels (``ops/cuda/warp.py``) for a CUDA tensor and
through the plain version (``ops/sampling.py``) for a CPU tensor.
"""

from __future__ import annotations

from collections.abc import Sequence

import torch

from supervised_dispnet_tpu_torch.ops.cuda.warp import (
    bilinear_sample_cuda, bilinear_sample_many_cuda)
from supervised_dispnet_tpu_torch.ops.sampling import bilinear_sample


def sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
           padding_mode: str = "zeros", diff_img: bool = True) -> torch.Tensor:
    """Bilinear sample of img (B, H, W, C) at pixel coordinates x, y
    (B, Ho, Wo): the CUDA kernels for a CUDA tensor, the plain version for a
    CPU tensor. ``diff_img=False``: img is data and takes no gradient."""
    if img.device.type == "cuda":
        return bilinear_sample_cuda(img, x, y, padding_mode, diff_img)
    if img.device.type == "cpu":
        return bilinear_sample(img if diff_img else img.detach(), x, y, padding_mode)
    raise ValueError(f"sample: no implementation for device {img.device}")


def sample_many(imgs: Sequence[torch.Tensor], xs: Sequence[torch.Tensor],
                ys: Sequence[torch.Tensor], padding_mode: str = "zeros") -> list[torch.Tensor]:
    """Bilinear samples of imgs[i] (B, H, W, C) at pixel coordinates xs[i],
    ys[i] (B, Ho, Wo), shapes free to differ between problems; the images
    are data and take no gradient. CUDA tensors: one grouped kernel launch
    each way for the whole group; CPU tensors: the plain version, problem by
    problem."""
    if not imgs:
        raise ValueError("sample_many: no problem given")
    device = imgs[0].device
    if device.type == "cuda":
        return bilinear_sample_many_cuda(imgs, xs, ys, padding_mode)
    if device.type == "cpu":
        return [bilinear_sample(img.detach(), x, y, padding_mode)
                for img, x, y in zip(imgs, xs, ys, strict=True)]
    raise ValueError(f"sample_many: no implementation for device {device}")


def euler2mat(angle: torch.Tensor) -> torch.Tensor:
    """Euler angles (B, 3) = (x, y, z) -> rotation matrices (B, 3, 3),
    R = Rx @ Ry @ Rz."""
    x, y, z = angle[:, 0], angle[:, 1], angle[:, 2]
    cx, sx = torch.cos(x), torch.sin(x)
    cy, sy = torch.cos(y), torch.sin(y)
    cz, sz = torch.cos(z), torch.sin(z)
    ones, zeros = torch.ones_like(x), torch.zeros_like(x)
    xmat = torch.stack([ones, zeros, zeros, zeros, cx, -sx, zeros, sx, cx],
                       dim=-1).reshape(-1, 3, 3)
    ymat = torch.stack([cy, zeros, sy, zeros, ones, zeros, -sy, zeros, cy],
                       dim=-1).reshape(-1, 3, 3)
    zmat = torch.stack([cz, -sz, zeros, sz, cz, zeros, zeros, zeros, ones],
                       dim=-1).reshape(-1, 3, 3)
    return xmat @ ymat @ zmat


def quat2mat(quat: torch.Tensor) -> torch.Tensor:
    """Quaternion imaginary part (B, 3) -> rotation matrices (B, 3, 3); w is
    set to 1 before normalisation."""
    q = torch.cat([torch.ones_like(quat[:, :1]), quat], dim=1)
    q = q / torch.linalg.vector_norm(q, dim=1, keepdim=True)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    w2, x2, y2, z2 = w * w, x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [w2 + x2 - y2 - z2, 2 * (xy - wz), 2 * (xz + wy),
         2 * (xy + wz), w2 - x2 + y2 - z2, 2 * (yz - wx),
         2 * (xz - wy), 2 * (yz + wx), w2 - x2 - y2 + z2], dim=-1).reshape(-1, 3, 3)


def pose_vec2mat(vec: torch.Tensor, rotation_mode: str = "euler") -> torch.Tensor:
    """6-DoF pose vector (B, 6) -> (B, 3, 4) transform [R | t]."""
    if rotation_mode == "euler":
        rot = euler2mat(vec[:, 3:])
    elif rotation_mode == "quat":
        rot = quat2mat(vec[:, 3:])
    else:
        raise ValueError(f"unknown rotation_mode: {rotation_mode!r}")
    return torch.cat([rot, vec[:, :3, None]], dim=2)


def pixel2cam(depth: torch.Tensor, intrinsics_inv: torch.Tensor) -> torch.Tensor:
    """Back-project every pixel: depth (B, H, W), K^-1 (B, 3, 3) -> camera
    coordinates (B, H, W, 3)."""
    B, H, W = depth.shape
    ys, xs = torch.meshgrid(torch.arange(H, dtype=depth.dtype, device=depth.device),
                            torch.arange(W, dtype=depth.dtype, device=depth.device),
                            indexing="ij")
    pix = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1).reshape(1, H * W, 3)
    rays = pix @ intrinsics_inv.transpose(1, 2)  # (B, H*W, 3)
    return rays.reshape(B, H, W, 3) * depth[..., None]


def cam2pixel(cam_coords: torch.Tensor, proj_rot: torch.Tensor, proj_tr: torch.Tensor,
              bounds: tuple[int, int] | None = None):
    """Project camera-frame points (B, H, W, 3) with K @ R (B, 3, 3) and
    K @ t (B, 3, 1) into pixel coordinates. ``bounds`` (H_src, W_src) is the
    source plane's extent for the validity test (default: cam_coords' own).
    Returns x, y (B, H, W) and valid (B, H, W) bool: in view (1e-3 pixel
    slack) and in front (Z > 1e-3)."""
    B, H, W, _ = cam_coords.shape
    if bounds is not None:
        H, W = bounds
    p = (cam_coords.reshape(B, -1, 3) @ proj_rot.transpose(1, 2)
         + proj_tr[:, None, :, 0]).reshape(*cam_coords.shape)
    X, Y, Z = p[..., 0], p[..., 1], p[..., 2]
    Zc = Z.clamp(min=1e-3)
    x, y = X / Zc, Y / Zc
    eps = 1e-3
    valid = (x >= -eps) & (x <= W - 1 + eps) & (y >= -eps) & (y <= H - 1 + eps) & (Z > 1e-3)
    return x, y, valid


def warp_coords(depth: torch.Tensor, pose: torch.Tensor, intrinsics: torch.Tensor,
                bounds: tuple[int, int], rotation_mode: str = "euler",
                tgt_intrinsics: torch.Tensor | None = None):
    """The inverse warp's geometry: where each target pixel of depth
    (B, Ht, Wt) lands in a source plane of ``bounds`` (H, W), moved by the
    target->source pose (B, 6), with the source intrinsics (B, 3, 3)
    (``tgt_intrinsics`` back-projects the target, default ``intrinsics``).
    Returns x, y (B, Ht, Wt) pixel coordinates and valid (B, Ht, Wt) bool."""
    K_t = intrinsics if tgt_intrinsics is None else tgt_intrinsics
    cam_coords = pixel2cam(depth, torch.linalg.inv_ex(K_t).inverse)
    proj = intrinsics @ pose_vec2mat(pose, rotation_mode)  # K @ [R | t]
    return cam2pixel(cam_coords, proj[:, :, :3], proj[:, :, 3:], bounds=bounds)


def inverse_warp(img: torch.Tensor, depth: torch.Tensor, pose: torch.Tensor,
                 intrinsics: torch.Tensor, rotation_mode: str = "euler",
                 padding_mode: str = "zeros", diff_img: bool = True,
                 tgt_intrinsics: torch.Tensor | None = None):
    """Inverse-warp the source image img (B, H, W, C) into the target frame
    from the target depth (B, Ht, Wt), the target->source pose (B, 6) and
    the source intrinsics (B, 3, 3) (``tgt_intrinsics`` back-projects the
    target, default ``intrinsics``). ``diff_img=False``: img is data (the
    photometric loss), and the backward forms the coordinate gradients only.
    Returns (warped (B, Ht, Wt, C), valid (B, Ht, Wt) bool)."""
    x, y, valid = warp_coords(depth, pose, intrinsics, (img.shape[1], img.shape[2]),
                              rotation_mode, tgt_intrinsics)
    return sample(img, x, y, padding_mode, diff_img), valid
