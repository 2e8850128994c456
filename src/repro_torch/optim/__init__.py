from .optimizer import (AdamWConfig, CompressionState, accumulate_gradients,
                        adamw_init, adamw_update, clip_by_global_norm,
                        compress_int8, compressed_gradients, cosine_schedule,
                        decompress_int8, factored_slots, global_norm,
                        slot_of, stacked_layout)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_schedule",
           "global_norm", "clip_by_global_norm", "accumulate_gradients",
           "compress_int8", "decompress_int8", "compressed_gradients",
           "CompressionState", "stacked_layout", "slot_of", "factored_slots"]
