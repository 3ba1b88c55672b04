"""The port's int8 PTQ against the JAX package's on VGG16-BN, fused decoder
and not: calibration, the stage chain (BN folded, each conv requantized to
the next one's range), the per-stage fused decoder or the per-conv one, the
baked weights
(``tests/test_torch_quant.py`` states the tolerances and their reasons)."""

import pytest

from tests.torch_quant_ref import check_apply, check_bake, check_calibration, check_close_to_float
from tests.torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("cid,percentile", [("vgg-fused", None), ("vgg-fused", 99.9),
                                            ("vgg", None)])
def test_calibration_matches_jax(cid, percentile):
    check_calibration(cid, percentile)


@pytest.mark.parametrize("cid", ["vgg-fused", "vgg"])
def test_quantized_apply_matches_jax(cid):
    check_apply(cid)


def test_int8_close_to_float():
    check_close_to_float("vgg-fused", 0.02, 0.2)


def test_bake_matches_jax_and_baked_forward_is_live():
    check_bake("vgg-fused")
