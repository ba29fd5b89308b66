"""Config system: model / engine / parallelism / training, all dataclasses.

Every assigned architecture is a ``ModelConfig`` in
``repro_torch.configs.<id>``; the registry maps ``--arch <id>`` to (full
config, reduced smoke config).  A copy of the JAX package's ``config.py``,
kept equal to it by ``tests/test_torch_config.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    capacity_factor: float = 1.25
    router_jitter: float = 0.0
    #: auxiliary load-balancing loss weight (Switch-style)
    aux_loss_weight: float = 0.01
    #: independent dispatch groups (per-shard EP-style dispatch; keeps the
    #: sort/scatter batched over a DP-sharded dim -- see models/moe.py)
    dispatch_groups: int = 16


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style: Mamba2 backbone + one *shared* attention block applied
    every ``attn_every`` layers (same weights each application)."""
    attn_every: int = 6


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Which matrix engine executes model GEMMs (the paper's technique as a
    first-class feature)."""
    kind: str = "xla"              # "xla" | "pallas_rasa"
    schedule: str = "wls"          # RASA schedule for the Pallas engine
    block_m: int = 256
    block_k: int = 512
    block_n: int = 256
    #: flash-attention kernel for prefill when on TPU
    flash_attention: bool = False
    flash_block_q: int = 512
    flash_block_kv: int = 512
    #: XLA-path chunk sizes (memory/HLO-size trade; the roofline
    #: reduced-depth compiles set these to seq_len so cost_analysis counts
    #: every chunk -- scan bodies are counted once)
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 2048
    ce_chunk: int = 256
    #: unroll the SSD chunk scan (roofline d-compiles only)
    unroll_ssd: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0               # 0 for attention-free
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0              # 0 -> d_model // n_heads
    act: str = "swiglu"            # swiglu | geglu | relu2 | gelu
    qk_norm: bool = False
    rope: str = "standard"         # standard | mrope | none
    rope_theta: float = 10000.0
    rms_eps: float = 1e-6
    tie_embeddings: bool = False
    #: normalization of attention logits for stability at depth
    logit_softcap: float = 0.0
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    #: stub modality frontend: none | vision | audio (input_specs provides
    #: precomputed patch/frame embeddings -- see DESIGN.md §4)
    frontend: str = "none"
    #: audio: number of EnCodec codebooks (musicgen)
    n_codebooks: int = 1
    #: supports O(1)-state long-context decode (SSM/hybrid)
    subquadratic: bool = False
    #: fuse the gate+up projections into one GEMM (x read once, one weight
    #: load serves two outputs -- the WL-skip idea at model level; §Perf)
    fuse_gate_up: bool = False
    dtype: str = "bfloat16"

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, v = self.d_model, self.vocab
        hd = self.resolved_head_dim
        total = v * d                                  # embedding
        if not self.tie_embeddings:
            total += d * v * self.n_codebooks          # lm head(s)
        n_attn = self.n_layers
        if self.family == "ssm":
            n_attn = 0
        elif self.family == "hybrid":
            n_attn = 1                                 # one shared block
        # attention
        attn = (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                + self.n_heads * hd * d) if self.n_heads else 0
        total += n_attn * attn
        # ffn / experts
        if self.moe:
            ff = self.moe.n_experts * 3 * d * self.moe.d_ff_expert \
                + d * self.moe.n_experts
            total += self.n_layers * ff
        elif self.d_ff:
            mult = 3 if self.act in ("swiglu", "geglu") else 2
            per_layer_ff = mult * d * self.d_ff
            n_ff = self.n_layers if self.family != "hybrid" else 1
            total += n_ff * per_layer_ff
        # ssm blocks
        if self.ssm is not None:
            di = self.ssm.expand * d
            h = di // self.ssm.head_dim
            g = self.ssm.n_groups
            per = (d * (2 * di + 2 * g * self.ssm.d_state + h)   # in_proj
                   + self.ssm.d_conv * (di + 2 * g * self.ssm.d_state)
                   + di * d                                      # out_proj
                   + 2 * h + di)                                 # A, D, norm
            total += self.n_layers * per
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top_k of n_experts)."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        inactive = (self.moe.n_experts - self.moe.top_k) * 3 * d * self.moe.d_ff_expert
        return self.param_count() - self.n_layers * inactive


@dataclasses.dataclass(frozen=True)
class ParallelConfig:
    data: int = 16
    model: int = 16
    pods: int = 1
    #: FSDP: shard parameters (and optimizer state) over the data axes
    fsdp: bool = True
    #: sequence parallelism for long-context decode (shard KV cache on seq)
    sequence_parallel_decode: bool = False
    #: remat policy for the layer scan: "full" | "dots" | "none"
    remat: str = "full"
    #: scan over layers (True, production: O(1) HLO in depth) or unroll a
    #: python loop (False: used by the reduced-depth roofline compiles,
    #: where cost_analysis must count every layer)
    scan_layers: bool = True
    #: optimizer state dtype ("float32" | "bfloat16"); bf16 halves optimizer
    #: HBM for the largest configs (grok-1-314b)
    opt_state_dtype: str = "float32"
    #: parameter sharding at serving time: "fsdp" re-uses the training
    #: layout (per-step all-gathers), "tp" shards only over "model" --
    #: the right layout for inference (no optimizer state to co-shard);
    #: see EXPERIMENTS.md §Perf hillclimb (collective term)
    serve_param_sharding: str = "fsdp"

    @property
    def dp_axes(self) -> tuple[str, ...]:
        return ("pod", "data") if self.pods > 1 else ("data",)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 256
    seq_len: int = 4096
    microbatches: int = 1
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    b1: float = 0.9
    b2: float = 0.95
    seed: int = 0
    #: int8 error-feedback gradient compression over the DP axes
    grad_compression: bool = False
    checkpoint_every: int = 200
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3


@dataclasses.dataclass(frozen=True)
class RunConfig:
    model: ModelConfig
    train: TrainConfig = TrainConfig()
    parallel: ParallelConfig = ParallelConfig()
    engine: EngineConfig = EngineConfig()


#: the four assigned input shapes (LM family): (seq_len, global_batch, kind)
SHAPES: dict[str, tuple[int, int, str]] = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}
