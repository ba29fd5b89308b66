"""qwen2-vl-72b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
M-RoPE, dynamic resolution (stub patch-embedding frontend).
[arXiv:2409.12191; hf]"""

from ..config import ModelConfig, ParallelConfig, RunConfig

FULL = RunConfig(
    model=ModelConfig(
        name="qwen2-vl-72b", family="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, head_dim=128,
        act="swiglu", rope="mrope", rope_theta=1e6,
        frontend="vision",
    ),
    parallel=ParallelConfig(opt_state_dtype="bfloat16"),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="qwen2-vl-72b-smoke", family="vlm",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=128, vocab=512, head_dim=16,
        act="swiglu", rope="mrope", frontend="vision",
    ),
)
