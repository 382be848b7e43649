from .adamw import AdamW, clip_by_global_norm
from .schedule import cosine_schedule, constant_schedule
from .compression import (compress_int8, compress_tree, decompress_int8,
                          decompress_tree, CompressionState)

__all__ = ["AdamW", "clip_by_global_norm", "cosine_schedule",
           "constant_schedule", "compress_int8", "compress_tree",
           "decompress_int8", "decompress_tree", "CompressionState"]
