"""musicgen-large [audio]: 48L d=2048 32H (kv=32) d_ff=8192 vocab=2048.

A decoder-only transformer over EnCodec tokens [arXiv:2306.05284]: a
LayerNorm/GELU block with sinusoidal positions and a 2048-way codec
head. The EnCodec frontend is a stub: the model takes precomputed frame
embeddings (B, S, d), so it has no token embedding and serves through
``training.steps.make_serve_steps``, not the token engine."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    norm_type="layernorm", act="gelu", pos_emb="sincos",
    embed_input=False,          # stub frame embeddings
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="musicgen-large-reduced", family="audio",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=256,
    norm_type="layernorm", act="gelu", pos_emb="sincos",
    embed_input=False, attn_impl="naive", remat=False,
)

register("musicgen-large", CONFIG, REDUCED)
