"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) expert d_ff=512
vocab=49155, MoE 40 experts top-8.  (Pool prose says 32e; structured field
40e top-8 wins -- matches hf:ibm-granite/granite-3.0-3b-a800m-base.)
The tiny 512-wide expert GEMMs are exactly the register-limited small-tile
regime RASA targets -- see benchmarks/rasa_llm_projection.py.
[hf; verified]"""

from ..config import ModelConfig, MoEConfig, RunConfig

FULL = RunConfig(
    model=ModelConfig(
        name="granite-moe-3b-a800m", family="moe",
        n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
        d_ff=0, vocab=49155, head_dim=64,
        act="swiglu", rope="standard",
        moe=MoEConfig(n_experts=40, top_k=8, d_ff_expert=512),
    ),
)

SMOKE = RunConfig(
    model=ModelConfig(
        name="granite-moe-3b-a800m-smoke", family="moe",
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
        d_ff=0, vocab=512, head_dim=16, act="swiglu",
        moe=MoEConfig(n_experts=8, top_k=4, d_ff_expert=32, capacity_factor=4.0),
    ),
)
