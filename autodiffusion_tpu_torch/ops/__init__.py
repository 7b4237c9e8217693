"""Hand-written Hopper kernels (CUDA C++ in ``csrc/``) and their plain twins."""

from .flash_attention import (LAUNCHES, FlashAttentionFunction, flash_attention,
                              flash_attention_reference, reset_launch_counts)

__all__ = ["LAUNCHES", "FlashAttentionFunction", "flash_attention",
           "flash_attention_reference", "reset_launch_counts"]
