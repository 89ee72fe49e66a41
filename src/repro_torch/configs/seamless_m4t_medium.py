"""seamless-m4t-medium [audio] — enc-dec, multimodal [arXiv:2308.11596].

12L d_model=1024 16H (MHA) d_ff=4096 vocab=256206.  Encoder-decoder: 12
encoder + 12 decoder layers.  There is no audio frontend (fbank/w2v-BERT):
the caller gives precomputed frame embeddings (``prefix_embeds``,
n_prefix_tokens frames) to the encoder.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,          # per stack: 12 enc + 12 dec
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    n_prefix_tokens=1024,  # encoder frame positions (stub embeddings)
)
