"""musicgen-large [audio]: 48L d=2048 32H (kv=32) d_ff=8192 vocab=2048.
Decoder-only over EnCodec tokens; 4 codebooks (stub frame-embedding
frontend sums the per-codebook embeddings; one lm head per codebook).
RoPE replaces the original sinusoidal positions -- noted in DESIGN.md.
[arXiv:2306.05284; hf]"""

from ..config import ModelConfig, RunConfig

FULL = RunConfig(
    model=ModelConfig(
        name="musicgen-large", family="audio",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=8192, vocab=2048, head_dim=64,
        act="gelu", rope="standard", n_codebooks=4, frontend="audio",
    ),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="musicgen-large-smoke", family="audio",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
        d_ff=128, vocab=128, head_dim=16,
        act="gelu", n_codebooks=4, frontend="audio",
    ),
)
