"""gemma-7b [dense]: 28L d=3072 16H (kv=16) d_ff=24576 vocab=256000.
GeGLU, head_dim=256, tied embeddings. [arXiv:2403.08295; hf]"""

from ..config import ModelConfig, RunConfig

FULL = RunConfig(
    model=ModelConfig(
        name="gemma-7b", family="dense",
        n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16,
        d_ff=24576, vocab=256000, head_dim=256,
        act="geglu", rope="standard", tie_embeddings=True,
    ),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="gemma-7b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=256, vocab=512, head_dim=32,
        act="geglu", tie_embeddings=True,
    ),
)
