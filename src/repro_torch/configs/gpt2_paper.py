"""gpt2-paper: the paper's GPT2 evaluation model (Table III: 163M params,
25 Q2_K + 24 Q3_K MatMul layers, 77 MB).

GPT2-base is 124M; the paper's 163M count corresponds to an *untied*
lm_head (124M + 38.6M), and 49 MatMul layers = 12 blocks x 4 + lm_head.
Fused c_attn, LayerNorm, GELU, learned positions."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="gpt2-paper", family="gpt2",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=50257,
    norm_type="layernorm", act="gelu", pos_emb="learned",
    fused_qkv=True, max_position=1024,
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="gpt2-paper-reduced", family="gpt2",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512,
    norm_type="layernorm", act="gelu", pos_emb="learned",
    fused_qkv=True, max_position=256, attn_impl="naive", remat=False,
)

register("gpt2-paper", CONFIG, REDUCED)
