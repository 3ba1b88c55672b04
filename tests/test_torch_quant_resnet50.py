"""The port's int8 PTQ against the JAX package's on DispResNet-50, fused
decoder: calibration, the Bottleneck encoder chain (a downsample conv's
output and the block's rounded to bf16 before their add) with the int8
decoder chain, and the int8 forward against the float one
(``tests/test_torch_quant.py`` states the tolerances and their reasons)."""

from tests.torch_quant_ref import check_apply, check_calibration, check_close_to_float
from tests.torch_threads import cap_torch_threads

cap_torch_threads()


def test_calibration_matches_jax():
    check_calibration("res50-fused")


def test_quantized_apply_matches_jax():
    check_apply("res50-fused")


def test_int8_close_to_float():
    check_close_to_float("res50-fused", 0.05)
