"""AdamW, ZeRO-1 placement and gradient compression (the port of the
reference's ``optim`` package, plain PyTorch)."""
from .adamw import (AdamWConfig, ModelShards, Zero1, accumulate_grads,
                    adamw_abstract, adamw_init, adamw_update,
                    cosine_schedule, global_norm, model_shards,
                    value_and_grad, zero1_shardings)
from .compress import (compress_tree, compressed_psum_mean,
                       dequantize_int8, quantize_int8)

__all__ = ["AdamWConfig", "adamw_init", "adamw_abstract", "adamw_update",
           "cosine_schedule",
           "global_norm", "zero1_shardings", "accumulate_grads",
           "value_and_grad", "Zero1", "ModelShards", "model_shards",
           "quantize_int8", "dequantize_int8",
           "compress_tree", "compressed_psum_mean"]
