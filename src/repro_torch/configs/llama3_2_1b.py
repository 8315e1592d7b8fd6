"""llama3.2-1b [dense]: 16L d=2048 32H (GQA kv=8) d_ff=8192 vocab=128256."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="llama3.2-1b", family="dense",
    n_layers=16, d_model=2048, n_heads=32, n_kv_heads=8,
    d_ff=8192, vocab_size=128256, rope_theta=5e5,
    tie_embeddings=True,        # llama3.2-1b ties lm_head to embeddings
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="llama3.2-1b-reduced", family="dense",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512, rope_theta=5e5,
    tie_embeddings=True, attn_impl="naive", remat=False,
)

register("llama3.2-1b", CONFIG, REDUCED)
