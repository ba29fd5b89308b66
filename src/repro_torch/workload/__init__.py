"""Real-model workload frontend: compile ``repro_torch.configs`` models into
chip-schedulable :class:`Workload`s (see :mod:`repro_torch.workload.compile`)."""

from .compile import (
    DEFAULT_OPTIONS,
    PHASES,
    CompileOptions,
    Workload,
    WorkloadOp,
    compile_workload,
    layer_ops,
)

__all__ = [
    "DEFAULT_OPTIONS",
    "PHASES",
    "CompileOptions",
    "Workload",
    "WorkloadOp",
    "compile_workload",
    "layer_ops",
]
