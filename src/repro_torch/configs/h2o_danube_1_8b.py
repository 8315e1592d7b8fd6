"""h2o-danube-1.8b [dense]: 24L d=2560 32H (GQA kv=8) d_ff=6912 vocab=32000.

llama+mistral mix with sliding-window attention (window 4096), which makes
decode state O(window): the KV ring holds only the window."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="h2o-danube-1.8b", family="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8,
    d_ff=6912, vocab_size=32000, rope_theta=1e4,
    sliding_window=4096,
    subquadratic=True,          # sliding window: a ring of the window
)

REDUCED = ModelConfig(
    name="h2o-danube-1.8b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, rope_theta=1e4,
    sliding_window=64, subquadratic=True, attn_impl="naive", remat=False,
)

register("h2o-danube-1.8b", CONFIG, REDUCED)
