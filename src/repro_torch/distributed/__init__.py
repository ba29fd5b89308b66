"""Distribution substrate of the port: mesh-aware sharding rules over a
``DeviceMesh`` (DTensor placements), counterpart of the JAX package's
``repro.distributed``."""

from .sharding import (ACTIVATION_KINDS, MeshContext, NamedSharding, activation_spec,
                       constrain, current_ctx, decode_state_shardings, distribute,
                       kv_cache_spec, mesh_context, param_spec, param_specs,
                       shardings_for)

__all__ = ["ACTIVATION_KINDS", "MeshContext", "NamedSharding", "activation_spec",
           "constrain", "current_ctx", "decode_state_shardings", "distribute",
           "kv_cache_spec", "mesh_context", "param_spec", "param_specs", "shardings_for"]
