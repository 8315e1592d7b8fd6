"""tinyllama-1.1b: the paper's TinyLlama evaluation model (Table III: 1.1B,
45 Q2_K + 110 Q3_K MatMul layers, 460 MB). 22L d=2048 32H kv=4 d_ff=5632."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="tinyllama-1.1b", family="dense",
    n_layers=22, d_model=2048, n_heads=32, n_kv_heads=4,
    d_ff=5632, vocab_size=32000, rope_theta=1e4,
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="tinyllama-1.1b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, rope_theta=1e4,
    attn_impl="naive", remat=False,
)

register("tinyllama-1.1b", CONFIG, REDUCED)
