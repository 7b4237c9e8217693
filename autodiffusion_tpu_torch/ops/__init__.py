"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their plain twins."""

from ._build import LAUNCHES, NHWC_LAUNCHES, reset_launch_counts
from .conv_im2col import (conv3x3, conv3x3_fused, conv3x3_im2col,
                          resolve_use_fused_conv, resolve_use_im2col)
from .flash_attention import (FlashAttentionFunction, flash_attention,
                              flash_attention_reference)
from .fused_norm import (fused_group_norm, fused_norm_available,
                         group_norm_reference, is_nhwc, memory_format)

__all__ = ["LAUNCHES", "NHWC_LAUNCHES", "reset_launch_counts",
           "FlashAttentionFunction", "flash_attention",
           "flash_attention_reference", "fused_group_norm",
           "fused_norm_available", "group_norm_reference", "is_nhwc",
           "memory_format", "conv3x3", "conv3x3_im2col", "conv3x3_fused",
           "resolve_use_im2col", "resolve_use_fused_conv"]
