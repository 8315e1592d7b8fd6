"""qwen2-vl-72b [vlm]: 80L d=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.

M-RoPE [arXiv:2409.12191]: the rotary frequencies split into (temporal,
height, width) sections, each rotated by its own position stream. The
vision frontend is a stub: the model takes precomputed patch/text
embeddings (B, S, d) and the (3, B, S) position streams, so it has no
token embedding and serves through ``training.steps.make_serve_steps``,
not the token engine.

d_ff = 29568 is not a multiple of 256, so the down projections fall back
to Q8_0 at serve time, as llama.cpp does for such tensors."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="qwen2-vl-72b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=29568, vocab_size=152064,
    pos_emb="mrope", mrope_sections=(16, 24, 24), rope_theta=1e6,
    embed_input=False,          # stub patch/text embeddings
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="qwen2-vl-72b-reduced", family="vlm",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=512, vocab_size=512,
    pos_emb="mrope", mrope_sections=(8, 12, 12), rope_theta=1e6,
    embed_input=False, attn_impl="naive", remat=False,
)

register("qwen2-vl-72b", CONFIG, REDUCED)
