"""Hand-written Hopper kernels of the port, with their plain versions.

- :mod:`repro_torch.kernels.rasa_gemm` -- RASA-scheduled GEMM (CUDA,
  ``csrc/rasa_gemm.cu``), its wrapper, plain version, launch counts and
  cost model (the wrapper function is not re-exported here, so that
  ``repro_torch.kernels.rasa_gemm`` stays the module)
- :mod:`repro_torch.kernels.ops`       -- device dispatch (``rasa_matmul``)
- :mod:`repro_torch.kernels.ref`       -- plain-torch oracles
"""

from . import ref
from .ops import rasa_matmul
from .rasa_gemm import SCHEDULES, GemmBlocks, default_blocks, schedule_cost

__all__ = ["rasa_matmul", "GemmBlocks", "SCHEDULES", "default_blocks",
           "schedule_cost", "ref"]
