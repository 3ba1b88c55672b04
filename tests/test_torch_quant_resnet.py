"""The port's int8 PTQ against the JAX package's on DispResNet-18, fused
decoder (and unfused: the decoder's convs one by one) (``tests/test_torch_quant.py`` states the tolerances and
their reasons): calibration with the blocks' ``::out`` and the fused stages'
``::skip`` keys, the encoder chain, the per-conv encoder (``::out`` keys
dropped), the int8 decoder chain, the per-stage path (an ``exempt``
predicate), the multi-scale disparity heads and the bin-logit heads.
DispResNet-50 is in ``test_torch_quant_resnet50.py``."""

import pytest

from tests.torch_quant_ref import check_apply, check_bake, check_calibration, check_close_to_float
from tests.torch_threads import cap_torch_threads

cap_torch_threads()


@pytest.mark.parametrize("cid,percentile", [
    ("res18-fused", None), ("res18-fused", 99.9), ("res18-fused-multiscale-class", None),
    ("res18", None)])
def test_calibration_matches_jax(cid, percentile):
    check_calibration(cid, percentile)


@pytest.mark.parametrize("cid,exempt,drop", [
    ("res18-fused", False, False), ("res18-fused", False, True), ("res18-fused", True, False),
    ("res18-fused-multiscale-class", False, False), ("res18", False, False)],
    ids=["res18-chains", "res18-per-conv-encoder", "res18-per-stage", "res18-class-heads",
         "res18-unfused-decoder"])
def test_quantized_apply_matches_jax(cid, exempt, drop):
    check_apply(cid, exempt, drop)


def test_int8_close_to_float():
    check_close_to_float("res18-fused", 0.02, 0.2)


def test_bake_matches_jax_and_baked_forward_is_live():
    check_bake("res18-fused")
