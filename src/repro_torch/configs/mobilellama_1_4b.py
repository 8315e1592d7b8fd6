"""mobilellama-1.4b: the paper's MobileLLaMA evaluation model (Table III:
1.4B, 49 Q2_K + 120 Q3_K MatMul layers, 560 MB). 24L d=2048 16H kv=16
d_ff=5632 [arXiv:2312.16886]."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mobilellama-1.4b", family="dense",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=5632, vocab_size=32000, rope_theta=1e4,
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="mobilellama-1.4b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512, rope_theta=1e4,
    attn_impl="naive", remat=False,
)

register("mobilellama-1.4b", CONFIG, REDUCED)
