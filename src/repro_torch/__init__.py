"""PyTorch + CUDA port of the RASA framework, for NVIDIA Hopper (H100).

Beside the JAX package ``repro`` (the reference), with the same layout:
``config``/``configs``, ``kernels`` (hand-written CUDA for ``sm_90a`` with
plain PyTorch versions), ``models`` and ``serving``.  It imports torch and
never jax or ``repro``.  Entry points run on ``device="cuda"`` unless the
caller asks for the CPU.
"""

from .config import EngineConfig, ModelConfig, RunConfig
from .configs import ARCH_NAMES, get_config

__all__ = ["EngineConfig", "ModelConfig", "RunConfig", "ARCH_NAMES",
           "get_config"]
