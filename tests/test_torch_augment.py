"""The port's augmentation against the JAX package's, on the CPU: the JAX
draws are recomputed from its key-split recipe and handed to the port's
``augment_batch(draws=...)``; images, intrinsics and sparse depth must
agree."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.data.augment import AugmentConfig as JaxAugmentConfig
from supervised_dispnet_tpu.data.augment import augment_batch as jax_augment_batch
from supervised_dispnet_tpu.data.augment import normalize_images as jax_normalize
from supervised_dispnet_tpu_torch.data.augment import (
    AugmentConfig, augment_batch, draw_augment, normalize_images)

B, S, H, W = 3, 2, 24, 40


def jax_draws(key, config: JaxAugmentConfig) -> dict[str, np.ndarray]:
    """The random numbers ``augment_batch`` draws from ``key``, by its own
    recipe (seven subkeys: scale, ox, oy, flip, brightness, contrast,
    saturation)."""
    k_scale, k_ox, k_oy, k_flip, k_b, k_c, k_s = jax.random.split(key, 7)
    f32 = jnp.float32
    if config.scale_crop:
        sc = jax.random.uniform(k_scale, (B, 2), f32, 1.0, config.max_scale)
        sx, sy = sc[:, 0], sc[:, 1]
    else:
        sx = sy = jnp.ones((B,), f32)
    draws = {"scale_x": sx, "scale_y": sy,
             "ox": jax.random.uniform(k_ox, (B,), f32) * (sx - 1.0) * W,
             "oy": jax.random.uniform(k_oy, (B,), f32) * (sy - 1.0) * H,
             "flip": (jax.random.bernoulli(k_flip, 0.5, (B,)) if config.flip
                      else jnp.zeros((B,), bool))}
    if config.color_jitter:
        for name, k, a in (("brightness", k_b, config.brightness),
                           ("contrast", k_c, config.contrast),
                           ("saturation", k_s, config.saturation)):
            draws[name] = jax.random.uniform(k, (B, 1, 1, 1, 1), f32, 1.0 - a, 1.0 + a)
    return {k: np.array(v).reshape(B) for k, v in draws.items()}


def _inputs(seed):
    rng = np.random.default_rng(seed)
    imgs = rng.uniform(0, 1, (B, S, H, W, 3)).astype(np.float32)
    K = np.array([[60.0, 0, W / 2], [0, 55.0, H / 2], [0, 0, 1]], np.float32)
    depth = (rng.uniform(1, 80, (B, H, W)) * (rng.uniform(size=(B, H, W)) < 0.2))
    return imgs, np.tile(K, (B, 1, 1)), depth.astype(np.float32)


CONFIGS = {
    "full": {},
    "flip_only": {"scale_crop": False, "color_jitter": False},
    "scale_crop_only": {"flip": False, "color_jitter": False},
    "none": {"flip": False, "scale_crop": False, "color_jitter": False},
    "imagenet_norm": {"mean": (0.485, 0.456, 0.406), "std": (0.229, 0.224, 0.225)},
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("seed", [0, 1])
def test_augment_matches_jax_with_its_draws(name, seed):
    """Images atol 1e-5 (the resample sums two taps in another order);
    intrinsics rtol 1e-6; nearest-tap depth exactly."""
    imgs, K, depth = _inputs(seed)
    jcfg, cfg = JaxAugmentConfig(**CONFIGS[name]), AugmentConfig(**CONFIGS[name])
    key = jax.random.PRNGKey(seed + 10)
    ref_imgs, ref_K, ref_d = jax_augment_batch(
        key, jnp.asarray(imgs), jnp.asarray(K), jnp.asarray(depth), config=jcfg)
    draws = {k: torch.from_numpy(v) for k, v in jax_draws(key, jcfg).items()}
    out, new_K, d = augment_batch(torch.from_numpy(imgs), torch.from_numpy(K),
                                  torch.from_numpy(depth), config=cfg, draws=draws)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_imgs), rtol=0, atol=1e-5)
    np.testing.assert_allclose(new_K.numpy(), np.asarray(ref_K), rtol=1e-6, atol=1e-5)
    np.testing.assert_array_equal(d.numpy(), np.asarray(ref_d))


def test_augment_without_depth_returns_images_and_intrinsics():
    imgs, K, _ = _inputs(2)
    out = augment_batch(torch.from_numpy(imgs), torch.from_numpy(K),
                        generator=torch.Generator().manual_seed(0))
    assert len(out) == 2
    assert out[0].shape == imgs.shape and out[1].shape == K.shape


def test_draws_from_a_generator_are_in_range_and_reproducible():
    cfg = AugmentConfig()
    a = draw_augment(64, H, W, cfg, torch.Generator().manual_seed(3))
    b = draw_augment(64, H, W, cfg, torch.Generator().manual_seed(3))
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert ((a["scale_x"] >= 1.0) & (a["scale_x"] < cfg.max_scale)).all()
    assert ((a["ox"] >= 0) & (a["ox"] <= (a["scale_x"] - 1) * W)).all()
    assert ((a["brightness"] >= 0.8) & (a["brightness"] < 1.2)).all()
    assert 0 < int(a["flip"].sum()) < 64


def test_hue_jitter_rotates_hue_and_keeps_luma():
    """Hue rotation turns the chroma (YIQ's I, Q) and keeps the luma Y, up
    to the [0, 1] clip; the JAX parity is ``test_torch_train_options.py``'s."""
    imgs, K, _ = _inputs(0)
    imgs = 0.25 + 0.5 * imgs  # away from the clip
    draws = draw_augment(B, H, W, AugmentConfig(hue=0.1), torch.Generator().manual_seed(1))
    draws.update(brightness=torch.ones(B), contrast=torch.ones(B), saturation=torch.ones(B),
                 scale_x=torch.ones(B), scale_y=torch.ones(B), ox=torch.zeros(B),
                 oy=torch.zeros(B), flip=torch.zeros(B, dtype=torch.bool))
    out, _ = augment_batch(torch.from_numpy(imgs), torch.from_numpy(K),
                           config=AugmentConfig(hue=0.1, mean=(0, 0, 0), std=(1, 1, 1)),
                           draws=draws)
    luma = torch.tensor([0.299, 0.587, 0.114])
    x = torch.from_numpy(imgs)
    np.testing.assert_allclose((out @ luma).numpy(), (x @ luma).numpy(), atol=1e-5)
    assert (out - x).abs().max() > 1e-2


def test_normalize_images_matches_jax():
    x = np.random.default_rng(4).uniform(0, 1, (2, 5, 7, 3)).astype(np.float32)
    mean, std = (0.485, 0.456, 0.406), (0.229, 0.224, 0.225)
    np.testing.assert_allclose(normalize_images(torch.from_numpy(x), mean, std).numpy(),
                               np.asarray(jax_normalize(jnp.asarray(x), mean, std)),
                               rtol=1e-6, atol=1e-6)
