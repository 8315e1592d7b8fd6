"""qwen3-1.7b [dense]: 28L d=2048 16H (GQA kv=8) d_ff=6144 vocab=151936.

qk_norm per-head RMSNorm on q/k (Qwen3 family signature feature)."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=6144, vocab_size=151936, rope_theta=1e6,
    qk_norm=True,
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="qwen3-1.7b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, rope_theta=1e6,
    qk_norm=True, attn_impl="naive", remat=False,
)

register("qwen3-1.7b", CONFIG, REDUCED)
