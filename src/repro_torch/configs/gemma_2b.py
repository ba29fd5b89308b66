"""gemma-2b [dense]: 18L d=2048 8H (MQA kv=1) d_ff=16384 vocab=256000.
GeGLU, head_dim=256, tied embeddings. [arXiv:2403.08295; hf]"""

from ..config import ModelConfig, RunConfig

FULL = RunConfig(
    model=ModelConfig(
        name="gemma-2b", family="dense",
        n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_ff=16384, vocab=256000, head_dim=256,
        act="geglu", rope="standard", tie_embeddings=True,
    ),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="gemma-2b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=256, vocab=512, head_dim=32,
        act="geglu", tie_embeddings=True,
    ),
)
