import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (ROOT / "perfbench", ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

#: Models at a size a CPU test holds, in the configurations' ``port`` form:
#: fp32, so that the program and the reference choose the same tokens.
TINY = {
    "dense": {"name": "tiny-dense", "family": "dense", "n_layers": 2,
              "d_model": 64, "n_heads": 4, "n_kv_heads": 1, "head_dim": 16,
              "d_ff": 128, "vocab": 512, "rope_theta": 10000.0,
              "tie_embeddings": True, "norm_eps": 1e-5,
              "param_dtype": "float32", "compute_dtype": "float32",
              "logit_dtype": "float32"},
    "ssm": {"name": "tiny-ssm", "family": "ssm", "n_layers": 2, "d_model": 64,
            "n_heads": 0, "n_kv_heads": 0, "d_ff": 0, "vocab": 512,
            "ssm": {"d_state": 16, "head_dim": 8, "expand": 2, "chunk": 16,
                    "conv_width": 4},
            "tie_embeddings": True, "norm_eps": 1e-5,
            "param_dtype": "float32", "compute_dtype": "float32",
            "logit_dtype": "float32"},
}
