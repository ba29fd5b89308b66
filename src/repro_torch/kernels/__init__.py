"""Hand-written Hopper kernels of the port, with their plain versions.

- :mod:`repro_torch.kernels.rasa_gemm` -- RASA-scheduled GEMM (CUDA,
  ``csrc/rasa_gemm.cu``), its wrapper, plain version, launch counts and
  cost model (the wrapper function is not re-exported here, so that
  ``repro_torch.kernels.rasa_gemm`` stays the module)
- :mod:`repro_torch.kernels.flash_attention` -- flash attention (CUDA,
  ``csrc/flash_attention.cu``), its wrapper, plain version, launch count
- :mod:`repro_torch.kernels.ssd_chunk` -- the fused Mamba2 SSD scan (CUDA,
  ``csrc/ssd_chunk.cu``), its entry point ``ssd_chunk_fused``, plain
  version, launch count and cost model ``hbm_bytes_fused``
- :mod:`repro_torch.kernels.fastsim_scan` -- the RASA simulator's two
  scans (CUDA, ``csrc/fastsim.cu``): the full-stream scan and the MM-only
  scan, their wrappers, plain versions and launch counts (used by
  :mod:`repro_torch.core.fastsim`)
- :mod:`repro_torch.kernels.ops` -- device dispatch (``rasa_matmul``,
  ``flash_mha``)
- :mod:`repro_torch.kernels.ref` -- plain-torch oracles
"""

from . import ref
from .ops import flash_mha, rasa_matmul
from .rasa_gemm import SCHEDULES, GemmBlocks, default_blocks, schedule_cost
from .ssd_chunk import hbm_bytes_fused, ssd_chunk_fused

__all__ = ["rasa_matmul", "flash_mha", "ssd_chunk_fused", "hbm_bytes_fused",
           "GemmBlocks", "SCHEDULES", "default_blocks", "schedule_cost", "ref"]
