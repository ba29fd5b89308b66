"""mamba2-130m [ssm]: 24L d=768 (attention-free) vocab=50280, ssm_state=128.
SSD (state-space duality), chunked. [arXiv:2405.21060; unverified]"""

from ..config import ModelConfig, RunConfig, SSMConfig

FULL = RunConfig(
    model=ModelConfig(
        name="mamba2-130m", family="ssm",
        n_layers=24, d_model=768, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=50280, rope="none",
        ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                      n_groups=1, chunk=256),
        subquadratic=True, tie_embeddings=True,
    ),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="mamba2-130m-smoke", family="ssm",
        n_layers=2, d_model=64, n_heads=0, n_kv_heads=0,
        d_ff=0, vocab=512, rope="none",
        ssm=SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                      n_groups=1, chunk=32),
        subquadratic=True, tie_embeddings=True,
    ),
)
