from .conv1d import conv1d_trunc_f32, conv1d_trunc_f32_reference
from .conv2d import (
    conv2d_trunc_f32,
    conv2d_trunc_f32_batched,
    conv2d_trunc_f32_batched_reference,
    conv2d_trunc_f32_grouped,
    conv2d_trunc_f32_reference,
    conv2d_trunc_f32_tile,
)
from .conv2d_f64 import (
    conv2d_trunc_f64,
    conv2d_trunc_f64_batched,
    conv2d_trunc_f64_batched_reference,
    conv2d_trunc_f64_reference,
)

__all__ = [
    "conv1d_trunc_f32",
    "conv1d_trunc_f32_reference",
    "conv2d_trunc_f32",
    "conv2d_trunc_f32_batched",
    "conv2d_trunc_f32_batched_reference",
    "conv2d_trunc_f32_grouped",
    "conv2d_trunc_f32_reference",
    "conv2d_trunc_f32_tile",
    "conv2d_trunc_f64",
    "conv2d_trunc_f64_batched",
    "conv2d_trunc_f64_batched_reference",
    "conv2d_trunc_f64_reference",
]
