"""``paddle.nn.functional`` surface of the port (so far: attention)."""
from .attention import (flash_attention, flash_attn_unpadded,
                        scaled_dot_product_attention)

__all__ = ["flash_attention", "flash_attn_unpadded",
           "scaled_dot_product_attention"]
