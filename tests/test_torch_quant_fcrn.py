"""The port's int8 PTQ against the JAX package's on FCRN: calibration (its
float forward agrees with JAX's to rtol 1e-3 only, as
``tests/test_torch_vgg_fcrn.py`` holds it: the unpool convs sum in another
order, so the ranges are held to that), the ResNet-50 encoder chain and the
lhs-dilated unpool convs, the baked weights. Its depth is compared with a
floor of 1e-3 of its largest value, where its ReLU cuts to 0; against the
float forward, as JAX's own test holds random-init FCRN, to its shape and
finiteness (``tests/test_torch_quant.py`` states the other tolerances)."""

import pytest

from tests.torch_quant_ref import check_apply, check_bake, check_calibration, check_close_to_float
from tests.torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("percentile", [None, 99.9])
def test_calibration_matches_jax(percentile):
    check_calibration("fcrn", percentile, rtol=1e-3)


def test_quantized_apply_matches_jax():
    check_apply("fcrn")


def test_int8_shape_and_finite():
    check_close_to_float("fcrn", 0.05)


def test_bake_matches_jax_and_baked_forward_is_live():
    check_bake("fcrn")
