"""phi3-mini-3.8b [dense]: 32L d=3072 32H (GQA kv=32) d_ff=8192 vocab=32064.

RoPE + SwiGLU; kv=32 means full multi-head attention (no GQA sharing).
d_head = 96."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="phi3-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32064, rope_theta=1e4,
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="phi3-mini-3.8b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512, rope_theta=1e4,
    attn_impl="naive", remat=False,
)

register("phi3-mini-3.8b", CONFIG, REDUCED)
