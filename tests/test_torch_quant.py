"""The port's int8 PTQ (``ops/quant.py``) against the JAX package's, on the
CPU, on DispNetS: calibration, the int8 twin's forward (the DownsampleConv
chain, per-conv iconvs, bf16 heads), the baked weights. The ResNet and
VGG-BN / FCRN networks are in ``test_torch_quant_resnet.py`` and
``test_torch_quant_vgg_fcrn.py``; the shared cases and checks in
``tests/torch_quant_ref.py``.

Weights go across through ``utils/convert.py``; BN statistics are the
batch's. The JAX side runs as ``tests/test_quant.py`` runs it: fp32,
``jax.jit`` where it jits.

Tolerances and why:
- calibration: the same keys, values rtol 1e-4 (the float forwards sum in
  other orders, and with the batch's BN statistics the two frameworks'
  activations part by up to 3e-5; FCRN's by 1.1e-4, held at the 1e-3 its
  float parity test uses);
- the int8 forward against JAX's on the same ranges: the int32 sums are
  exact on both sides, but a code flips by one where a float value before
  a rounding lies within an ulp of a half. JAX's jitted graph rounds some
  epilogues otherwise than its op-by-op form (XLA fuses them; op by op the
  DispNetS chain and DispResNet decoder chain agree bit for bit), XLA's
  expm1 is not torch's (10% of ELU outputs differ in the last bit), and on
  the per-conv path the float BN between int8 convs rounds otherwise than
  flax's (half of its outputs differ in the last bit). So the finest
  disparity is held within median rel 1e-3 and max rel 2e-2, the coarser
  ones' median within 1e-3. The tight comparison runs JAX op by op: under
  ``jax.jit`` XLA's CPU rewrites (a division by a constant scale becomes a
  product with its reciprocal, a product and a sum one FMA) round the
  epilogues otherwise, which the issue's arithmetic and the kernel do not;
  one case holds the jitted graph too, at median 5e-3 / max 5e-2;
- the port's int8 forward against its float one: JAX's thresholds
  (``tests/test_quant.py``);
- baked weights: the int8 weights equal, the scales rtol 1e-6; a baked
  twin's forward equals the live one bit for bit.
"""

import numpy as np
import pytest
import torch

from supervised_dispnet_tpu.ops import quant as jq
from supervised_dispnet_tpu_torch.ops import quant as pq
from tests.torch_quant_ref import (
    H, W, X, case, check_apply, check_bake, check_calibration, check_close_to_float, listed)
from tests.torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibration_matches_jax(percentile):
    check_calibration("dispnet", percentile)


def test_multi_batch_calibration_takes_max_and_degenerate_raises():
    jm, v, pm, r1 = case("dispnet")
    x = torch.from_numpy(X)
    r2 = pq.calibrate_conv_ranges(pm, [x, 3.0 * x])
    want = jq.calibrate_conv_ranges(jm, v, [X, 3.0 * X])
    assert sorted(r2) == sorted(r1) and all(r2[k] >= r1[k] for k in r1)
    for k in want:
        np.testing.assert_allclose(r2[k], want[k], rtol=1e-5, err_msg=k)
    with pytest.raises(ValueError, match="degenerate"):
        pq.calibrate_conv_ranges(pm, [torch.zeros(1, H, W, 3)])


def test_exempt_predicate_drops_the_exempt_convs():
    _, _, pm, r_all = case("dispnet")
    stem = lambda m: tuple(m.kernel_size) == (7, 7)  # noqa: E731
    r_ex = pq.calibrate_conv_ranges(pm, [torch.from_numpy(X)], exempt=stem)
    assert set(r_all) - set(r_ex) == {"conv1/conv_a/Conv_0", "conv1/conv_b/Conv_0"}
    assert set(r_ex) < set(r_all)


@pytest.mark.parametrize("exempt", [False, True], ids=["downsample-chain", "per-conv"])
def test_quantized_apply_matches_jax(exempt):
    check_apply("dispnet", exempt=exempt)


def test_quantized_apply_near_jitted_jax():
    """Against JAX's jitted graph, whose CPU rewrites round the epilogues
    otherwise (``tests/torch_quant_ref.py::jax_int8``): median rel 5e-3,
    max rel 5e-2 (measured 1.2e-3 and 1.6e-2)."""
    check_apply("dispnet", jit=True, med=5e-3, top=5e-2)


def test_int8_close_to_float():
    check_close_to_float("dispnet", 0.02, 0.15)


def test_bake_matches_jax_and_baked_forward_is_live():
    check_bake("dispnet")


def test_empty_ranges_is_identity():
    _, _, pm, _ = case("dispnet")
    x = torch.from_numpy(X)
    with torch.no_grad():
        for g, w in zip(listed(pq.quantized_apply(pm, x, ranges={})), listed(pm(x))):
            np.testing.assert_array_equal(g, w)
