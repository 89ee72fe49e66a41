"""mamba2-2.7b [ssm] — SSD state-space duality [arXiv:2405.21060].

64L d_model=2560 attention-free, vocab=50280, ssm_state=128.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256),
    tie_embeddings=True,
)
