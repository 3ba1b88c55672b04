"""PyTorch + CUDA port of ``supervised_dispnet_tpu`` for one NVIDIA H100.

It mirrors the JAX package's module paths and keeps its NHWC layout at the
public functions, so each module has an obvious counterpart to be held
against. It imports ``torch`` and numpy, never JAX and nothing of the JAX
package. This ``__init__`` imports nothing, so submodules load alone.
"""
