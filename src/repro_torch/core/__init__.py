"""RASA core: the paper's contribution, ported (the JAX package's
``core/``).

- :mod:`repro_torch.core.isa`       -- AMX-like tile ISA + register file w/ dirty bits
- :mod:`repro_torch.core.designs`   -- baseline + 7 RASA designs (Control x Data)
- :mod:`repro_torch.core.timing`    -- cycle-level sub-stage pipeline model
- :mod:`repro_torch.core.tiling`    -- register-aware GEMM lowering (Algorithm 1)
- :mod:`repro_torch.core.engine`    -- functional (numerics) execution, in torch
- :mod:`repro_torch.core.workloads` -- Table I layer set
- :mod:`repro_torch.core.area`      -- area/power/energy model (published constants)
- :mod:`repro_torch.core.trace`     -- SoA trace compilation (cached lowering)
- :mod:`repro_torch.core.fastsim`   -- numpy / plain torch / CUDA lanes over compiled traces
- :mod:`repro_torch.core.simulator` -- evaluation driver (backend dispatch)
"""

from .designs import DESIGNS, EngineConfig, get_design
from .fastsim import StreamModelParams
from .isa import (NUM_TREGS, TILE_K, TILE_M, TILE_N, Instr, Op,
                  TileRegisterFile, count_ops, tile_bytes, validate_stream)
from .simulator import (BACKENDS, SimReport, normalized_runtime, simulate,
                        sweep_designs, sweep_workload)
from .tiling import (ALG1_POLICY, MAX_REUSE_POLICY, GemmSpec, RegPolicy,
                     lower_gemm, lowered_stream, stream_stats)
from .timing import (LoadStreamModel, PipelineSimulator, TimingResult,
                     serial_mm_latency, steady_state_interval)
from .trace import CompiledTrace, compile_stream, compiled_trace, gemm_trace
from .workloads import TABLE_I, batch_sweep

__all__ = [
    "DESIGNS", "EngineConfig", "get_design",
    "NUM_TREGS", "TILE_K", "TILE_M", "TILE_N", "Instr", "Op",
    "TileRegisterFile", "count_ops", "tile_bytes", "validate_stream",
    "BACKENDS", "SimReport", "normalized_runtime", "simulate",
    "sweep_designs", "sweep_workload",
    "ALG1_POLICY", "MAX_REUSE_POLICY", "GemmSpec", "RegPolicy",
    "lower_gemm", "lowered_stream", "stream_stats",
    "LoadStreamModel", "PipelineSimulator", "TimingResult",
    "serial_mm_latency", "steady_state_interval",
    "CompiledTrace", "StreamModelParams", "compile_stream", "compiled_trace",
    "gemm_trace", "TABLE_I", "batch_sweep",
]
