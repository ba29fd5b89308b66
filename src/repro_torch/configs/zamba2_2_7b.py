"""zamba2-2.7b [hybrid]: 54L d=2560 32H (kv=32) d_ff=10240 vocab=32000,
ssm_state=64.  Mamba2 backbone + ONE shared attention+MLP block applied
every 6 layers (simplification of Zamba2's two alternating shared blocks;
DESIGN.md §Arch-applicability).  [arXiv:2411.15242; hf]"""

from ..config import HybridConfig, ModelConfig, RunConfig, SSMConfig

FULL = RunConfig(
    model=ModelConfig(
        name="zamba2-2.7b", family="hybrid",
        n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
        d_ff=10240, vocab=32000, head_dim=80,
        act="geglu", rope="standard",
        ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        hybrid=HybridConfig(attn_every=6),
        subquadratic=True, tie_embeddings=True,
    ),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="zamba2-2.7b-smoke", family="hybrid",
        n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=512, head_dim=16,
        act="geglu",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=32),
        hybrid=HybridConfig(attn_every=2),
        subquadratic=True, tie_embeddings=True,
    ),
)
