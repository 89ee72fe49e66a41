"""arctic-480b [moe] — 128 experts top-2 + dense residual
[hf:Snowflake/snowflake-arctic-base].

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 with a
parallel dense residual MLP per layer.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    d_ff=4864,
    vocab=32000,
    moe=MoEConfig(n_experts=128, top_k=2, capacity_factor=1.25,
                  dense_residual_ff=4864, dispatch="grouped"),
    remat="full",
)
