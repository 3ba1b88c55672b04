"""Synthetic ego-motion scenes with analytic ground truth, the port's copy
of ``supervised_dispnet_tpu/data/synthetic.py`` (numpy only; from the same
seed it gives the same arrays).

Renders 3-frame snippets (target + 2 refs) of a textured, tilted plane
seen from a moving camera. Because the scene is a plane, every view is an
exact warp of the same world texture, the target's depth map is analytic,
and the target->ref camera transforms are chosen by us, so the snippets
carry exact GT for both halves of the self-supervised objective (the
disparity and the pose nets trained jointly through ``inverse_warp``)
without KITTI.

Conventions match ``ops/warp.py``:
- pose (6,) = [tx, ty, tz, rx, ry, rz]; X_ref = R @ X_tgt + t with
  R = Rx @ Ry @ Rz (``ops/warp.py::euler2mat``);
- pinhole K, pixel (0,0) = center of the top-left pixel.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def euler_to_mat_np(angles: np.ndarray) -> np.ndarray:
    """(..., 3) euler angles (x, y, z) -> (..., 3, 3); R = Rx @ Ry @ Rz,
    the same composition as ops/warp.py::euler2mat."""
    x, y, z = angles[..., 0], angles[..., 1], angles[..., 2]
    cx, sx = np.cos(x), np.sin(x)
    cy, sy = np.cos(y), np.sin(y)
    cz, sz = np.cos(z), np.sin(z)
    o, i = np.zeros_like(x), np.ones_like(x)
    rx = np.stack([i, o, o, o, cx, -sx, o, sx, cx], -1).reshape(*x.shape, 3, 3)
    ry = np.stack([cy, o, sy, o, i, o, -sy, o, cy], -1).reshape(*x.shape, 3, 3)
    rz = np.stack([cz, -sz, o, sz, cz, o, o, o, i], -1).reshape(*x.shape, 3, 3)
    return rx @ ry @ rz


def _np_upsample_bilinear(img: np.ndarray, size: int) -> np.ndarray:
    """(h, w, C) -> (size, size, C) bilinear, pure numpy (no image
    library)."""
    Hs, Ws = img.shape[:2]
    ys = np.linspace(0, Hs - 1, size)
    xs = np.linspace(0, Ws - 1, size)
    y0 = np.floor(ys).astype(np.int64)
    x0 = np.floor(xs).astype(np.int64)
    y1 = np.minimum(y0 + 1, Hs - 1)
    x1 = np.minimum(x0 + 1, Ws - 1)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    a = img[y0][:, x0]
    b = img[y0][:, x1]
    c = img[y1][:, x0]
    d = img[y1][:, x1]
    return (a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx
            + c * fy * (1 - fx) + d * fy * fx)


def _smooth_texture(rng: np.random.Generator, size: int) -> np.ndarray:
    """(size, size, 3) smooth multi-octave texture in [0, 1] — enough
    high-frequency content for photometric gradients, smooth enough that
    bilinear resampling error stays small."""
    tex = np.zeros((size, size, 3), np.float32)
    amp = 1.0
    for cells in (6, 12, 24, 48):
        low = rng.uniform(0, 1, (cells, cells, 3)).astype(np.float32)
        tex += amp * _np_upsample_bilinear(low, size).astype(np.float32)
        amp *= 0.5
    tex -= tex.min()
    tex /= max(tex.max(), 1e-6)
    return 0.1 + 0.8 * tex


def _sample_texture(tex: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Bilinear texture lookup. u, v in texture-pixel coords, any shape;
    returns (..., 3)."""
    Ht, Wt = tex.shape[:2]
    # wrap (tile) rather than clamp: distant plane regions keep texture
    # gradients instead of degenerating into clamp streaks; the seam is a
    # world-anchored feature, so it stays photometrically consistent
    u = np.mod(u, Wt - 1.001)
    v = np.mod(v, Ht - 1.001)
    u0 = np.floor(u).astype(np.int64)
    v0 = np.floor(v).astype(np.int64)
    fu = (u - u0)[..., None]
    fv = (v - v0)[..., None]
    tl = tex[v0, u0]
    tr = tex[v0, u0 + 1]
    bl = tex[v0 + 1, u0]
    br = tex[v0 + 1, u0 + 1]
    return (tl * (1 - fu) * (1 - fv) + tr * fu * (1 - fv)
            + bl * (1 - fu) * fv + br * fu * fv)


@dataclasses.dataclass(frozen=True)
class PlaneSceneConfig:
    height: int = 128
    width: int = 416
    focal: float = 200.0
    nb_refs: int = 2
    # plane: depth at the image center ~ U(center_depth), tilt ~ U(+-tilt)
    center_depth: tuple[float, float] = (6.0, 14.0)
    tilt: float = 0.25
    # per-ref camera motion ranges (meters / radians)
    trans_xy: float = 0.25
    trans_z: float = 0.6
    rot: float = 0.02
    texture_size: int = 512
    texture_extent: float = 30.0  # world meters mapped to half the texture
    # foreground occluders (0 = the exact-warp plane-only scene): slanted
    # textured quads floating in front of the background plane. They give
    # the scene real depth STRUCTURE — a constant-disparity prediction
    # median-scales onto a lone smooth plane at ~0.15 abs_rel, which made
    # the plane-only convergence demonstration nearly vacuous. Occlusion
    # is resolved analytically (per-ray nearest hit), so GT depth stays
    # exact; photometric consistency breaks only at disocclusion fringes,
    # exactly like real data (the explainability mask's job).
    fg_planes: int = 0
    fg_depth: tuple[float, float] = (0.3, 0.5)  # quad center depth as a
    #   FRACTION of the background plane's center depth (absolute floor
    #   1.5 m) — keyed to z0 so the fg/bg depth contrast is >=2x in every
    #   scene, whatever center_depth was drawn
    fg_half_size: tuple[float, float] = (0.2, 0.4)  # quad half-extent as
    #   a FRACTION of the image's half-extent at the quad's depth — the
    #   ANGULAR size is what matters (a fixed metric size covers the
    #   whole image once the quad is near), so it is keyed to z_f and f
    fg_tilt: float = 0.4
    # room=True adds floor/ceiling/side-wall planes (a corridor seen down
    # +z). A SINGLE plane is homography-degenerate for SfM: any (depth,
    # pose) pair consistent with the inter-frame homography reconstructs
    # it exactly, so the photometric loss does not tie the depth map to
    # the true plane (observed: loss down, TRAIN abs_rel up). Two or more
    # planes make the motion — and with it per-pixel depth — unique, like
    # real scenes. Depth stays analytic (per-ray nearest hit).
    room: bool = False
    room_halfwidth: tuple[float, float] = (2.5, 4.5)  # wall distance (m)
    room_height: tuple[float, float] = (1.0, 1.8)  # floor/ceiling dist (m)


def _make_scene(rng: np.random.Generator, cfg: PlaneSceneConfig):
    """Build ONE random scene (background planes + occluder quads, all in
    the scene/frame-0 coordinate system) and return ``(render, K)`` where
    ``render(R, t)`` views it from the camera with X_cam = R @ X_0 + t and
    returns ``(image (H, W, 3), depth (H, W))``."""
    H, W, f = cfg.height, cfg.width, cfg.focal
    cx, cy = (W - 1) / 2.0, (H - 1) / 2.0
    K = np.array([[f, 0, cx], [0, f, cy], [0, 0, 1]], np.float32)

    # background: list of infinite textured planes (n . X = d in the
    # TARGET frame, with in-plane texture axes). Always includes the
    # tilted back plane; cfg.room adds floor/ceiling/side walls
    a, b = rng.uniform(-cfg.tilt, cfg.tilt, 2)
    n = np.array([a, b, 1.0])
    n /= np.linalg.norm(n)
    z0 = rng.uniform(*cfg.center_depth)
    d = z0 * n[2]  # center ray dir=(0,0,1): s = d / n_z = z0

    tex = _smooth_texture(rng, cfg.texture_size)
    ts = cfg.texture_size

    def _axes(n_p):
        u_ax = np.array([n_p[2], 0.0, -n_p[0]])
        u_ax /= np.linalg.norm(u_ax)
        return u_ax, np.cross(n_p, u_ax)

    bg = [(n, d, *_axes(n), cfg.texture_extent,
           np.zeros(2), 1.0)]  # (n, d, u_ax, v_ax, ext, tex_off, bright)
    if cfg.room:
        h_f, h_c = rng.uniform(*cfg.room_height, 2)
        w_l, w_r = rng.uniform(*cfg.room_halfwidth, 2)
        ax_h = (np.array([1.0, 0, 0]), np.array([0, 0, 1.0]))
        ax_v = (np.array([0, 1.0, 0]), np.array([0, 0, 1.0]))
        for n_p, d_p, (u_ax, v_ax) in (
                (np.array([0, 1.0, 0]), h_f, ax_h),   # floor (y down)
                (np.array([0, -1.0, 0]), h_c, ax_h),  # ceiling
                (np.array([-1.0, 0, 0]), w_l, ax_v),  # left wall
                (np.array([1.0, 0, 0]), w_r, ax_v)):  # right wall
            bg.append((n_p, d_p, u_ax, v_ax, 18.0,
                       rng.uniform(0, ts - 1, 2), rng.uniform(0.6, 1.0)))

    us = np.arange(W, dtype=np.float64)
    vs = np.arange(H, dtype=np.float64)
    uu, vv = np.meshgrid(us, vs)
    rays = np.stack([(uu - cx) / f, (vv - cy) / f, np.ones_like(uu)], -1)

    # foreground quads: (normal n_f, center C_f, in-plane axes u_f/v_f,
    # half-extents, texture offset, brightness) — all in the TARGET frame
    fg = []
    for _ in range(cfg.fg_planes):
        a_f, b_f = rng.uniform(-cfg.fg_tilt, cfg.fg_tilt, 2)
        n_f = np.array([a_f, b_f, 1.0])
        n_f /= np.linalg.norm(n_f)
        # anchor the quad on a ray through the central 60% of the image
        u0 = rng.uniform(0.2 * W, 0.8 * W)
        v0 = rng.uniform(0.2 * H, 0.8 * H)
        # depth relative to the background plane's center depth: the
        # fg/bg contrast (hence the structure a constant-disparity
        # prediction can't median-scale away) is controlled, not luck
        z_f = max(rng.uniform(*cfg.fg_depth) * z0, 1.5)
        C_f = z_f * np.array([(u0 - cx) / f, (v0 - cy) / f, 1.0])
        u_f = np.array([n_f[2], 0.0, -n_f[0]])
        u_f /= np.linalg.norm(u_f)
        v_f = np.cross(n_f, u_f)
        # angular sizing: fraction of the image half-extent at depth z_f
        ex = rng.uniform(*cfg.fg_half_size) * z_f * (W / 2) / f
        ey = rng.uniform(*cfg.fg_half_size) * z_f * (H / 2) / f
        off = rng.uniform(0.0, 0.5 * (cfg.texture_size - 1), 2)
        bright = rng.uniform(0.55, 1.0)
        fg.append((n_f, C_f, u_f, v_f, ex, ey, off, bright))

    def fg_tex(a_u, a_v, ex, ey, off, bright):
        u = (a_u / ex * 0.5 + 0.5) * 0.45 * (ts - 1) + off[0]
        v = (a_v / ey * 0.5 + 0.5) * 0.45 * (ts - 1) + off[1]
        return bright * _sample_texture(tex, u, v)

    def render(R, t):
        """View from camera with X_cam = R @ X_tgt + t; per-ray nearest
        hit over the background planes + foreground quads."""
        s = np.full((H, W), np.inf)
        col = np.zeros((H, W, 3), np.float32)
        for n_p, d_p, u_ax, v_ax, ext_p, off_p, br_p in bg:
            n_c = R @ n_p
            denom = rays @ n_c
            s_p = (d_p + n_c @ t) / np.where(np.abs(denom) < 1e-9,
                                             1e-9, denom)
            s_p = np.where(s_p > 0.3, s_p, np.inf)
            win = s_p < s
            if not win.any():
                continue
            s_safe = np.where(np.isfinite(s_p), s_p, 1.0)  # keep UV finite
            Xt = (s_safe[..., None] * rays - t) @ R  # back to target frame
            a_u, a_v = Xt @ u_ax, Xt @ v_ax
            c = br_p * _sample_texture(
                tex,
                (a_u / ext_p * 0.5 + 0.5) * (ts - 1) + off_p[0],
                (a_v / ext_p * 0.5 + 0.5) * (ts - 1) + off_p[1])
            col = np.where(win[..., None], c, col)
            s = np.where(win, s_p, s)
        for n_f, C_f, u_f, v_f, ex, ey, off, bright in fg:
            d_f = float(n_f @ C_f)
            n_fc = R @ n_f
            denom = rays @ n_fc
            s_f = (d_f + n_fc @ t) / np.where(np.abs(denom) < 1e-9,
                                              1e-9, denom)
            X_ft = (s_f[..., None] * rays - t) @ R
            rel = X_ft - C_f
            a_u, a_v = rel @ u_f, rel @ v_f
            hit = ((s_f > 0.3) & (np.abs(a_u) < ex) & (np.abs(a_v) < ey)
                   & (s_f < s))
            col = np.where(hit[..., None],
                           fg_tex(a_u, a_v, ex, ey, off, bright), col)
            s = np.where(hit, s_f, s)
        return col.astype(np.float32), s * rays[..., 2]

    return render, K


def render_snippet(rng: np.random.Generator, cfg: PlaneSceneConfig):
    """Render ONE snippet. Returns a dict of float32 arrays:
    tgt (H, W, 3), refs (R, H, W, 3), depth (H, W) analytic target depth,
    poses (R, 6) target->ref 6-DoF [t, euler], intrinsics (3, 3)."""
    render, K = _make_scene(rng, cfg)

    tgt, depth = render(np.eye(3), np.zeros(3))

    refs, poses = [], []
    for _ in range(cfg.nb_refs):
        ang = rng.uniform(-cfg.rot, cfg.rot, 3)
        t = np.array([rng.uniform(-cfg.trans_xy, cfg.trans_xy),
                      rng.uniform(-cfg.trans_xy / 2, cfg.trans_xy / 2),
                      rng.uniform(-cfg.trans_z, cfg.trans_z)])
        R = euler_to_mat_np(ang)
        img, _ = render(R, t)
        refs.append(img)
        poses.append(np.concatenate([t, ang]).astype(np.float32))

    return {
        "tgt": tgt,
        "refs": np.stack(refs),
        "depth": depth.astype(np.float32),
        "poses": np.stack(poses),
        "intrinsics": K,
    }


def render_batch(rng: np.random.Generator, batch: int,
                 cfg: PlaneSceneConfig = PlaneSceneConfig()):
    """Batch of snippets: dict of stacked arrays
    tgt (B, H, W, 3), ref_imgs (B, R, H, W, 3), depth (B, H, W),
    poses (B, R, 6), intrinsics (B, 3, 3)."""
    snippets = [render_snippet(rng, cfg) for _ in range(batch)]
    return {
        "tgt": np.stack([s["tgt"] for s in snippets]),
        "ref_imgs": np.stack([s["refs"] for s in snippets]),
        "depth": np.stack([s["depth"] for s in snippets]),
        "poses": np.stack([s["poses"] for s in snippets]),
        "intrinsics": np.stack([s["intrinsics"] for s in snippets]),
    }


def render_sequence(rng: np.random.Generator, n_frames: int,
                    cfg: PlaneSceneConfig = PlaneSceneConfig()):
    """Continuous camera trajectory through ONE scene — the synthetic
    stand-in for a KITTI odometry sequence (reference:
    ``kitti_eval/pose_evaluation_utils.py`` ATE protocol consumes
    ``sequences/NN/image_2`` + ``poses/NN.txt``).

    Per-frame motion is a random walk whose steps are drawn from the
    same ranges as :func:`render_snippet` ref motions (so a net trained
    on snippets sees in-domain inter-frame motion), with the cumulative
    forward displacement clamped so the camera never walks through the
    back plane. Returns ``frames (N, H, W, 3)`` float32 in [0, 1],
    ``poses (N, 3, 4)`` float32 cam-to-world in the frame-0 system
    (KITTI ``poses.txt`` row convention), and ``intrinsics (3, 3)``.
    """
    render, K = _make_scene(rng, cfg)
    R_wc, t_wc = np.eye(3), np.zeros(3)  # X_cam = R_wc @ X_0 + t_wc
    frames, poses, depths = [], [], []
    for _ in range(n_frames):
        img, dep = render(R_wc, t_wc)
        frames.append(img)
        depths.append(dep.astype(np.float32))
        R_cw = R_wc.T
        t_cw = -R_wc.T @ t_wc
        poses.append(np.concatenate([R_cw, t_cw[:, None]], 1)
                     .astype(np.float32))
        # step in the CURRENT camera frame, training-range magnitudes
        ang = rng.uniform(-cfg.rot, cfg.rot, 3)
        dt = np.array([rng.uniform(-cfg.trans_xy, cfg.trans_xy),
                       rng.uniform(-cfg.trans_xy / 2, cfg.trans_xy / 2),
                       rng.uniform(-cfg.trans_z, cfg.trans_z)])
        if abs(t_cw[2] + dt[2]) > 2.5:  # stay inside the corridor
            dt[2] = -dt[2]
        R_s = euler_to_mat_np(ang)
        R_wc = R_s @ R_wc
        t_wc = R_s @ t_wc + dt
    return {
        "frames": np.stack(frames),
        "depth": np.stack(depths),
        "poses": np.stack(poses),
        "intrinsics": K,
    }


def pose_errors(pred: np.ndarray, gt: np.ndarray):
    """Self-sup pose quality with the scale ambiguity factored out
    (the ATE protocol of kitti_eval/pose_evaluation_utils.py: per-snippet
    optimal translation scale). pred, gt: (B, R, 6).

    Returns (ate, rot_err): mean aligned translation error (meters) and
    mean rotation angle error (radians)."""
    t_p = pred[..., :3].reshape(-1, 3).astype(np.float64)
    t_g = gt[..., :3].reshape(-1, 3).astype(np.float64)
    # per-snippet scale: argmin_s ||s * t_p - t_g||
    num = (t_p * t_g).sum(-1)
    den = np.maximum((t_p * t_p).sum(-1), 1e-12)
    s = num / den
    ate = np.linalg.norm(s[:, None] * t_p - t_g, axis=-1).mean()
    R_p = euler_to_mat_np(pred[..., 3:].reshape(-1, 3))
    R_g = euler_to_mat_np(gt[..., 3:].reshape(-1, 3))
    rel = R_p @ np.swapaxes(R_g, -1, -2)
    tr = np.clip((np.trace(rel, axis1=-2, axis2=-1) - 1) / 2, -1.0, 1.0)
    rot_err = np.abs(np.arccos(tr)).mean()
    return float(ate), float(rot_err)


def scaled_abs_rel(pred_depth: np.ndarray, gt_depth: np.ndarray) -> float:
    """Median-scaled abs_rel (the self-sup eval protocol — reference:
    ``kitti_eval/depth_evaluation_utils.py`` median scaling)."""
    B = pred_depth.shape[0]
    errs = []
    for i in range(B):
        p, g = pred_depth[i], gt_depth[i]
        p = p * np.median(g) / max(np.median(p), 1e-9)
        errs.append(np.mean(np.abs(p - g) / g))
    return float(np.mean(errs))
