"""The int8 convolution's plain version (``ops/cuda/int8_conv.py``, the CPU
side of the custom op ``torch.ops.sdtpu.int8_conv``) against the JAX
package's int8 arithmetic, and the pieces around it: BN folding and the
flax-path map of ``utils/convert.py``. The kernel itself runs on the card
only, where ``chip_smoke.py::int8_phase`` holds it against this plain
version bit for bit.

- int32 accumulators equal ``lax.conv_general_dilated(int8 -> int32)``'s
  exactly, over stride 1 / 2, 1x1 / 3x3 / 5x5 / 6x6 / 7x7 (Cin 3), ragged
  channel counts, asymmetric padding, lhs dilation 2 and rhs dilation 2.
- The epilogue against JAX's ``_requant`` and the chains' residual adds, op
  by op: int8 codes equal for ReLU and none. For ELU, XLA's expm1 is not
  torch's (a last-bit difference on 10% of negative inputs), which moves a
  code by one where y / s lies within an ulp of a half: held at |diff| <= 1
  on at most 1e-4 of the codes (measured 0 of 98,304).
- ``fold_dispresnet`` against JAX's (rtol 1e-6) and the folded port model
  against the unfolded one (rtol 1e-5).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from supervised_dispnet_tpu.models import DispResNet as JaxDispResNet
from supervised_dispnet_tpu.ops import quant as jq
from supervised_dispnet_tpu.utils.fold_bn import fold_dispresnet as jax_fold
from supervised_dispnet_tpu_torch.models import FCRN, DispNetS, DispResNet, DispVggBN
from supervised_dispnet_tpu_torch.ops.cuda import int8_conv as ic
from supervised_dispnet_tpu_torch.utils import convert
from supervised_dispnet_tpu_torch.utils.fold_bn import fold_dispresnet
from tests.torch_quant_ref import jax_network
from tests.torch_threads import cap_torch_threads

cap_torch_threads()

GEOMETRIES = {
    "3x3-s1": (16, 3, (1, 1), ((1, 1), (1, 1)), (1, 1), (1, 1)),
    "7x7-s2-cin3": (3, 7, (2, 2), ((3, 3), (3, 3)), (1, 1), (1, 1)),
    "1x1-s2": (64, 1, (2, 2), ((0, 0), (0, 0)), (1, 1), (1, 1)),
    "5x5-lhs2-pad23": (8, 5, (1, 1), ((2, 3), (2, 3)), (2, 2), (1, 1)),
    "3x3-rhs2-asym": (5, 3, (1, 1), ((2, 1), (0, 2)), (1, 1), (2, 2)),
    "6x6-lhs2-fused": (16, 6, (1, 1), ((1, 1), (1, 1)), (2, 2), (1, 1)),
    "3x3-cin129": (129, 3, (1, 1), ((1, 1), (1, 1)), (1, 1), (1, 1)),
}


def _jax_acc(x, w_hwio, stride, pad, lhs, rhs):
    dn = lax.conv_dimension_numbers(x.shape, w_hwio.shape, ("NHWC", "HWIO", "NHWC"))
    return np.asarray(lax.conv_general_dilated(
        jnp.asarray(x), jnp.asarray(w_hwio), stride, pad, lhs_dilation=lhs,
        rhs_dilation=rhs, dimension_numbers=dn, preferred_element_type=jnp.int32))


def _case(gid, seed=0, cout=24):
    cin, k, stride, pad, lhs, rhs = GEOMETRIES[gid]
    rng = np.random.default_rng(seed)
    x = rng.integers(-127, 128, (2, 9, 11, cin)).astype(np.int8)
    w = rng.integers(-127, 128, (k, k, cin, cout)).astype(np.int8)
    geom = ic.Geometry(k, k, stride, (*pad[0], *pad[1]), lhs, rhs)
    packed = ic.pack_weight(torch.from_numpy(w).permute(3, 0, 1, 2).contiguous(), geom)
    return x, w, geom, packed, (stride, pad, lhs, rhs)


@pytest.mark.parametrize("gid", list(GEOMETRIES))
def test_accumulators_equal_lax(gid):
    x, w, geom, packed, args = _case(gid)
    want = _jax_acc(x, w, *args)
    got = ic.int8_conv(torch.from_numpy(x), packed, geom, torch.ones(24), torch.zeros(24),
                       out="s32")
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("act", ["none", "relu", "elu"])
def test_requant_codes_match_jax(act):
    rng = np.random.default_rng(3)
    acc = rng.integers(-2_000_000, 2_000_000, (4, 32, 48, 16)).astype(np.int32)
    mult = (rng.uniform(0.5, 2.0, 16) * 1e-6).astype(np.float32)
    bias = rng.normal(0, 0.3, 16).astype(np.float32)
    out_range = 2.7
    want, _ = jq._requant(jnp.asarray(acc), jnp.asarray(mult), jnp.asarray(bias), out_range,
                          act=None if act == "none" else act)
    got = ic.epilogue_plain(torch.from_numpy(acc), torch.from_numpy(mult),
                            torch.from_numpy(bias), None, ic.ACTS[act], ic.OUTS["s8"], 0, 0.0,
                            float(np.float32(out_range / 127.0)))
    diff = np.abs(got.numpy().astype(int) - np.asarray(want).astype(int))
    if act == "elu":
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-4
    else:
        np.testing.assert_array_equal(diff, 0)


@pytest.mark.parametrize("kind", ["identity", "downsample"])
def test_residual_epilogue_matches_jax_block_add(kind):
    """The ResNet chain's block end (JAX ``_int8_chain_encoder``): main
    ``acc * mult + b`` plus the int8 identity times its scale, or plus the
    downsample conv's output with both rounded to bf16, then ReLU and
    requantize."""
    rng = np.random.default_rng(5)
    shape = (2, 16, 24, 32)
    acc = rng.integers(-500_000, 500_000, shape).astype(np.int32)
    mult = (rng.uniform(0.5, 2.0, 32) * 1e-5).astype(np.float32)
    bias = rng.normal(0, 0.3, 32).astype(np.float32)
    s_h, s_o = np.float32(3.1 / 127.0), np.float32(6.3 / 127.0)
    main = jnp.asarray(acc).astype(jnp.float32) * jnp.asarray(mult) + jnp.asarray(bias)
    if kind == "identity":
        r = rng.integers(-127, 128, shape).astype(np.int8)
        idn = jnp.asarray(r).astype(jnp.float32) * s_h
        res, mode = torch.from_numpy(r), 1
    else:
        idn = jnp.asarray(rng.normal(0, 2, shape).astype(np.float32))
        main, idn = main.astype(jnp.bfloat16), idn.astype(jnp.bfloat16)
        res, mode = torch.from_numpy(np.asarray(idn.astype(jnp.float32))).bfloat16(), 2
    y = jnp.maximum((main + idn).astype(jnp.float32), 0.0)
    want = np.asarray(jnp.clip(jnp.round(y / s_o), -127.0, 127.0).astype(jnp.int8))
    got = ic.epilogue_plain(torch.from_numpy(acc), torch.from_numpy(mult),
                            torch.from_numpy(bias), res, 1, 2, mode, float(s_h), float(s_o))
    np.testing.assert_array_equal(got.numpy(), want)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x, _, geom, packed, _ = _case("3x3-s1")
    xt = torch.from_numpy(x)
    ones, zeros = torch.ones(24), torch.zeros(24)
    with pytest.raises(TypeError, match="int8"):
        ic.int8_conv(xt.float(), packed, geom, ones, zeros)
    with pytest.raises(ValueError, match="Kp"):
        ic.int8_conv(xt, packed[:, :-32], geom, ones, zeros)
    with pytest.raises(ValueError, match="mult"):
        ic.int8_conv(xt, packed, geom, ones[:5], zeros)
    with pytest.raises(ValueError, match="residual"):
        ic.int8_conv(xt, packed, geom, ones, zeros, residual=xt)
    with pytest.raises(TypeError, match="residual"):
        ic.int8_conv(xt, packed, geom, ones, zeros, residual=torch.zeros(2, 9, 11, 24))
    with pytest.raises(ValueError, match="act"):
        ic.int8_conv(xt, packed, geom, ones, zeros, act="gelu")


def test_fold_dispresnet_matches_jax_and_the_unfolded_model():
    x = np.random.default_rng(0).uniform(-1, 1, (2, 32, 64, 3)).astype(np.float32)
    jm, v = jax_network("disp_res_18", x)
    want = convert.dispresnet_folded_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_fold(v["params"], v["batch_stats"])), 18)
    got = fold_dispresnet(convert.dispresnet_from_jax(v["params"], v["batch_stats"], 18))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    folded, plain = DispResNet(18, fold_bn=True), DispResNet(18)
    folded.load_state_dict(got, strict=True)
    plain.load_state_dict(convert.dispresnet_from_jax(v["params"], v["batch_stats"], 18))
    assert isinstance(jm, JaxDispResNet) and not any("bn" in k for k in got if "encoder" in k)
    with torch.no_grad():
        for a, b in zip(folded.eval()(torch.from_numpy(x)), plain.eval()(torch.from_numpy(x))):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("net,depth", [("res18", 18), ("res50", 50), ("vgg", None),
                                       ("fcrn", None), ("dispnet", None)])
def test_flax_paths_name_every_conv_as_jax(net, depth):
    """Every conv of the port's network maps to the path of its JAX module,
    each once, and back (``port_name``)."""
    model = {"res18": lambda: DispResNet(18), "res50": lambda: DispResNet(50),
             "vgg": DispVggBN, "fcrn": FCRN, "dispnet": DispNetS}[net]()
    paths = convert.flax_paths(model)
    convs = [n for n, m in model.named_modules() if isinstance(m, torch.nn.Conv2d)]
    assert set(convs) <= set(paths)
    assert len(set(paths.values())) == len(paths)
    for name in convs:
        assert convert.port_name(model, paths[name]) == name
    if depth is not None:
        assert paths["encoder.layer4.1.conv2"] == "encoder/layer4_1/conv2"
        assert paths["encoder.layer2.0.downsample.0"] == "encoder/layer2_0/downsample_conv"
        assert paths["encoder.layer3.0"] == "encoder/layer3_0"
        assert paths["iconv3.0"] == "upconv3_1/Conv_0"
    if net == "vgg":
        assert paths["encoder.features.40"] == "stage4/conv2"
        assert paths["iconv0.0"] == "up0_1"
    if net == "fcrn":
        assert paths["up1.conv3"] == "up0/conv_b" and paths["layer1.0.conv1"] == \
            "encoder/layer1_0/conv1" and paths["conv2"] == "conv2"
    if net == "dispnet":
        assert paths["conv1.2"] == "conv1/conv_b/Conv_0"
