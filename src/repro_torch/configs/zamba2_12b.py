"""zamba2-1.2b [hybrid] — Mamba2 backbone + shared attention blocks
[arXiv:2411.15242].

38L d_model=2048 32H (GQA kv=32 → MHA) d_ff=8192 vocab=32000, ssm_state=64.
One shared transformer block (attention + MLP, single weight set) is applied
every 6 Mamba2 layers — the zamba2 weight-sharing scheme.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b",
    family="hybrid",
    n_layers=38,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=8192,
    vocab=32000,
    head_dim=64,
    ssm=SSMConfig(d_state=64, head_dim=64, expand=2, chunk=256),
    shared_attn_every=6,
    tie_embeddings=True,
)
