"""grok-1-314b [moe]: 64L d=6144 48H (GQA kv=8) expert d_ff=32768
vocab=131072, MoE 8 experts top-2. bf16 optimizer states (HBM budget --
see EXPERIMENTS.md roofline memory analysis). [hf:xai-org/grok-1; unverified]"""

from ..config import ModelConfig, MoEConfig, ParallelConfig, RunConfig

FULL = RunConfig(
    model=ModelConfig(
        name="grok-1-314b", family="moe",
        n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=0, vocab=131072, head_dim=128,
        act="gelu", rope="standard",
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
    ),
    parallel=ParallelConfig(opt_state_dtype="bfloat16"),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="grok-1-314b-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=0, vocab=512, head_dim=16, act="gelu",
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=4.0),
    ),
)
