"""paligemma-3b [vlm] — SigLIP + gemma backbone [arXiv:2407.07726].

18L d_model=2048 8H (GQA kv=1 → MQA) d_ff=16384 vocab=257216.
There is no SigLIP vision frontend: the caller gives 256 precomputed patch
embeddings per image (``prefix_embeds``), prepended under a prefix-LM mask.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    d_ff=16384,
    vocab=257216,
    head_dim=256,
    n_prefix_tokens=256,
    tie_embeddings=True,
)
