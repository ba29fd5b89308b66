"""Optimizer, schedule and gradient compression of the port (the JAX
package's ``repro.optim``)."""

from .adamw import AdamWState, adamw_init, adamw_update
from .compression import compress_int8, compressed_psum, decompress_int8
from .schedule import linear_warmup_cosine

__all__ = ["AdamWState", "adamw_init", "adamw_update", "linear_warmup_cosine",
           "compress_int8", "compressed_psum", "decompress_int8"]
