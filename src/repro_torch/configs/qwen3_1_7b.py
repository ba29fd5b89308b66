"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.
qk_norm, GQA. [hf:Qwen/Qwen3-8B; hf]"""

from ..config import ModelConfig, RunConfig

FULL = RunConfig(
    model=ModelConfig(
        name="qwen3-1.7b", family="dense",
        n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
        d_ff=6144, vocab=151936, head_dim=128,
        act="swiglu", qk_norm=True, rope="standard", rope_theta=1e6,
        tie_embeddings=True,
    ),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="qwen3-1.7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16,
        act="swiglu", qk_norm=True,
    ),
)
