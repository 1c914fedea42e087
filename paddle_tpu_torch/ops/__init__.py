"""Kernels and attention of the port. Importing this package builds
nothing: the CUDA library is compiled at the first kernel launch."""
from .attention import (dot_product_attention, flash_attention,
                        paged_attention, xla_attention)
from .flash_tpu import flash_attention_blhd, flash_attention_full
from .fused import fused_layer_norm

__all__ = ["dot_product_attention", "flash_attention", "paged_attention",
           "xla_attention", "flash_attention_blhd", "flash_attention_full",
           "fused_layer_norm"]
