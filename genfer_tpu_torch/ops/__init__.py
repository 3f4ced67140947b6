from .conv1d import conv1d_trunc_f32, conv1d_trunc_f32_reference
from .conv2d import (
    conv2d_trunc_f32,
    conv2d_trunc_f32_batched,
    conv2d_trunc_f32_batched_reference,
    conv2d_trunc_f32_grouped,
    conv2d_trunc_f32_reference,
    conv2d_trunc_f32_tile,
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
]
