"""The paper's own configuration: the RASA matrix engine + Table I workloads.

Counterpart of the JAX package's ``configs/rasa_paper.py``: the config the
reproduction benchmarks run; the LM architectures in this package consume
the engine through ``RunConfig.engine`` instead.
"""

from ..core.designs import DESIGNS, EngineConfig, get_design
from ..core.tiling import ALG1_POLICY, LOW_REUSE_POLICY, MAX_REUSE_POLICY
from ..core.workloads import TABLE_I

#: evaluation setup of §V
ARRAY_ROWS = 32
ARRAY_COLS = 16
ENGINE_CLOCK_HZ = 500e6
CORE_CLOCK_HZ = 2e9

__all__ = ["DESIGNS", "EngineConfig", "get_design", "TABLE_I",
           "ALG1_POLICY", "LOW_REUSE_POLICY", "MAX_REUSE_POLICY",
           "ARRAY_ROWS", "ARRAY_COLS", "ENGINE_CLOCK_HZ", "CORE_CLOCK_HZ"]
