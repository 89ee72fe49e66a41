"""llama110m — the paper's §6.5 case study: the Llama-2 architecture at 110M
parameters for edge LLM inference (TTFT/ITL).

Dimensions follow llama2.c's 110M config: 12L d_model=768 12H d_ff=2048.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama110m",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=2048,
    vocab=32000,
    param_dtype="float32",
    compute_dtype="float32",
    remat="none",
)
