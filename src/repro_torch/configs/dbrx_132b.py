"""dbrx-132b [moe] — 16 experts top-4, fine-grained [hf:databricks/dbrx-base].

40L d_model=6144 48H (GQA kv=8) d_ff=10752 vocab=100352, MoE 16e top-4.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    n_layers=40,
    d_model=6144,
    n_heads=48,
    n_kv_heads=8,
    d_ff=10752,
    vocab=100352,
    moe=MoEConfig(n_experts=16, top_k=4, capacity_factor=1.25,
                  dispatch="grouped"),
    remat="full",
)
