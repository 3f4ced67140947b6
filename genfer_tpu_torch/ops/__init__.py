from .conv2d import conv2d_trunc_f32, conv2d_trunc_f32_reference

__all__ = ["conv2d_trunc_f32", "conv2d_trunc_f32_reference"]
