"""Shared fixtures of the port's int8 tests: a JAX registry network with its
variables (numpy) and the port's network with the same weights.

The BN running statistics are set to the statistics of the batch the test
runs (as a trained model's describe its data), so that activations are
normalised: with the init's statistics a random ResNet-50's activations
reach ~1e4 and its int8 forward says nothing of a trained one. The JAX
model's train-mode forward gives them: each BN normalises with its batch
statistics whatever the running ones, and updates them as 0.9 old + 0.1
batch, which is solved for the batch's."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from supervised_dispnet_tpu.models import get_disp_net as jax_get_disp_net
from supervised_dispnet_tpu.models.common import model_takes_train
from supervised_dispnet_tpu_torch.models import get_disp_net
from supervised_dispnet_tpu_torch.utils import convert

DEPTHS = {"disp_res_18": 18, "disp_res_50": 50}


def _batch_stats(new, old):
    if isinstance(new, dict):
        return {k: _batch_stats(new[k], old[k]) for k in new}
    return ((np.asarray(new, np.float64) - 0.9 * np.asarray(old, np.float64)) / 0.1
            ).astype(np.float32)


def jax_network(name: str, x: np.ndarray, seed: int = 0, **kw):
    """(JAX model, numpy variables) with BN statistics of batch ``x``."""
    model = jax_get_disp_net(name, **kw)
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), jnp.asarray(x))
    if "batch_stats" in v:
        _, new = jax.jit(lambda v, x: model.apply(v, x, train=True, mutable=["batch_stats"]))(
            v, jnp.asarray(x))
        v = {"params": v["params"],
             "batch_stats": _batch_stats(jax.device_get(new["batch_stats"]),
                                         jax.device_get(v["batch_stats"]))}
    return model, jax.tree_util.tree_map(np.asarray, jax.device_get(v))


def port_state(name: str, v: dict, **kw) -> dict:
    """The port's state dict of JAX variables ``v`` of network ``name``."""
    if name in DEPTHS:
        return convert.dispresnet_from_jax(v["params"], v["batch_stats"], DEPTHS[name], **kw)
    if name == "dispnet":
        return convert.dispnet_from_jax(v["params"])
    if name == "disp_vgg_bn":
        return convert.disp_vgg_bn_from_jax(v["params"], v["batch_stats"])
    return convert.fcrn_from_jax(v["params"], v["batch_stats"])


def port_network(name: str, v: dict, fused_upsample: bool = False, **kw) -> torch.nn.Module:
    """The port's network ``name`` on the CPU, eval mode, with JAX's weights."""
    model = get_disp_net(name, fused_upsample=fused_upsample, device="cpu", **kw)
    sd_kw = ({k: kw[k] for k in ("head", "multiscale_classification") if k in kw}
             if name in DEPTHS else {})
    model.load_state_dict(port_state(name, v, **sd_kw))
    return model.eval()


def jax_apply(model, v, x):
    x = jnp.asarray(x)
    if model_takes_train(model):
        return model.apply(v, x, train=False)
    return model.apply(v, x)


def listed(out) -> list[np.ndarray]:
    outs = out if isinstance(out, (list, tuple)) else [out]
    return [np.asarray(o.detach() if isinstance(o, torch.Tensor) else o) for o in outs]


def rel_err(got: np.ndarray, want: np.ndarray, floor: float = 1e-6) -> np.ndarray:
    return np.abs(got - want) / np.maximum(np.abs(want), floor)


# ---------------------------------------------------------------------------
# the int8 tests' cases and checks (tests/test_torch_quant_*.py)
# ---------------------------------------------------------------------------

import functools  # noqa: E402

from supervised_dispnet_tpu.ops import quant as jq  # noqa: E402
from supervised_dispnet_tpu_torch.ops import quant as pq  # noqa: E402

B, H, W = 2, 64, 96
X = np.random.default_rng(0).uniform(-1.0, 1.0, (B, H, W, 3)).astype(np.float32)

CASES = {
    "dispnet": ("dispnet", {}),
    "res18": ("disp_res_18", {}),
    "res18-fused": ("disp_res_18", {"fused_upsample": True}),
    "res18-fused-multiscale-class": ("disp_res_18", {
        "fused_upsample": True, "head": "classification", "multiscale_classification": True}),
    "res50-fused": ("disp_res_50", {"fused_upsample": True}),
    "vgg": ("disp_vgg_bn", {}),
    "vgg-fused": ("disp_vgg_bn", {"fused_upsample": True}),
    "fcrn": ("fcrn", {}),
}


@functools.lru_cache(maxsize=None)
def case(cid: str):
    """(JAX model, variables, port model, JAX ranges) at ``X``."""
    name, kw = CASES[cid]
    jm, v = jax_network(name, X, **kw)
    pm = port_network(name, v, **kw)
    return jm, v, pm, jq.calibrate_conv_ranges(jm, v, [X])


@functools.lru_cache(maxsize=None)
def jax_int8(cid: str, exempt: bool = False, drop_out_keys: bool = False, jit: bool = False):
    """JAX's ``quantized_apply`` on ``X``, op by op or jitted. Under
    ``jax.jit`` XLA's CPU rewrites of the epilogue (a division by a
    constant scale becomes a product with its reciprocal, a product and a
    sum one FMA) round otherwise than the op-by-op graph, which rounds as
    the port and its kernel do."""
    jm, v, _, ranges = case(cid)
    if drop_out_keys:
        ranges = {k: r for k, r in ranges.items() if not k.endswith("::out")}
    ex = (lambda m: False) if exempt else None
    fn = lambda vv, xx: jq.quantized_apply(jm, vv, xx, ranges=ranges, exempt=ex)  # noqa: E731
    return listed((jax.jit(fn) if jit else fn)(v, X))


def check_calibration(cid: str, percentile: float | None = None, rtol: float = 1e-4) -> None:
    """The port's ranges: JAX's keys, values within ``rtol``."""
    jm, v, pm, r_max = case(cid)
    want = (r_max if percentile is None
            else jq.calibrate_conv_ranges(jm, v, [X], percentile=percentile))
    got = pq.calibrate_conv_ranges(pm, [torch.from_numpy(X)], percentile=percentile)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
        assert got[k] <= r_max[k] * (1 + 2 * rtol)


def check_apply(cid: str, exempt: bool = False, drop_out_keys: bool = False,
                jit: bool = False, med: float = 1e-3, top: float = 2e-2) -> None:
    """The int8 twin against JAX's ``quantized_apply`` (op by op, or
    jitted) on the same ranges: the finest output within median rel ``med``
    and max rel ``top``, the coarser ones' median within ``med`` (logits
    against their scale)."""
    _, _, pm, ranges = case(cid)
    if drop_out_keys:
        ranges = {k: r for k, r in ranges.items() if not k.endswith("::out")}
    twin = pq.QuantizedModel(pm, ranges, exempt=(lambda m: False) if exempt else None)
    resnet = cid.startswith(("res", "fcrn"))
    assert twin.dec_chain == (cid.startswith("res") and "fused" in cid and not exempt)
    assert twin.encoder_chain == (resnet and not (exempt or drop_out_keys))
    with torch.no_grad():
        got = listed(twin(torch.from_numpy(X)))
    want = jax_int8(cid, exempt, drop_out_keys, jit)
    assert len(got) == len(want)
    if "class" in cid:
        for g, w in zip(got, want):
            err = np.abs(g - w) / np.abs(w).max()
            assert np.median(err) <= med and err.max() <= top, (np.median(err), err.max())
        return
    floor = 1e-3 * np.abs(want[0]).max()  # FCRN's depth is 0 where its ReLU cuts
    rel = rel_err(got[0], want[0], floor)
    assert np.median(rel) <= med and rel.max() <= top, (np.median(rel), rel.max())
    for g, w in zip(got[1:], want[1:]):
        assert np.median(rel_err(g, w)) <= med


def check_close_to_float(cid: str, med: float, top: float | None = None) -> None:
    """The port's int8 forward against its float one, at JAX's thresholds
    (``tests/test_quant.py``): median (and max) rel of the finest output."""
    _, _, pm, ranges = case(cid)
    x = torch.from_numpy(X)
    with torch.no_grad():
        fp = listed(pm(x))[0]
        q = listed(pq.quantized_apply(pm, x, ranges=ranges))[0]
    assert q.shape == fp.shape and np.isfinite(q).all()
    if cid == "fcrn":  # JAX holds random-init FCRN to its shape and finiteness
        return
    rel = rel_err(q, fp)
    assert np.median(rel) < med, np.median(rel)
    if top is not None:
        assert rel.max() < top, rel.max()


def check_bake(cid: str) -> None:
    """``bake_int8_weights``: JAX's keys, int8 weights equal, scales and
    biases rtol 1e-6; a baked twin's forward equals the live one bit for
    bit."""
    jm, v, pm, ranges = case(cid)
    want = jq.bake_int8_weights(jm, v, ranges)
    got = pq.bake_int8_weights(pm, ranges)
    assert sorted(got) == sorted(want)
    for k, (wq, ws, bias) in want.items():
        gq, gs, gb = got[k]
        np.testing.assert_array_equal(gq.numpy(), np.asarray(wq).transpose(3, 0, 1, 2),
                                      err_msg=k)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=1e-6, err_msg=k)
        assert (gb is None) == (bias is None)
        if bias is not None:
            np.testing.assert_allclose(gb.numpy(), np.asarray(bias), rtol=1e-6, atol=1e-7,
                                       err_msg=k)
    x = torch.from_numpy(X)
    with torch.no_grad():
        baked = listed(pq.QuantizedModel(pm, ranges, baked=got)(x))
        live = listed(pq.QuantizedModel(pm, ranges)(x))
    for b, lv in zip(baked, live):
        np.testing.assert_array_equal(b, lv)
