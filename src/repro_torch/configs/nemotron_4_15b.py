"""nemotron-4-15b [dense]: 32L d=6144 48H (GQA kv=8) d_ff=24576 vocab=256000.
GQA, squared-ReLU MLP. [arXiv:2402.16819; unverified]"""

from ..config import ModelConfig, RunConfig

FULL = RunConfig(
    model=ModelConfig(
        name="nemotron-4-15b", family="dense",
        n_layers=32, d_model=6144, n_heads=48, n_kv_heads=8,
        d_ff=24576, vocab=256000, head_dim=128,
        act="relu2", rope="standard",
    ),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="nemotron-4-15b-smoke", family="dense",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=256, vocab=512, head_dim=16, act="relu2",
    ),
)
