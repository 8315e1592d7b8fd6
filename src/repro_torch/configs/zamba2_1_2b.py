"""zamba2-1.2b [hybrid]: 38L d=2048 32H (kv=32) d_ff=8192 vocab=32000,
ssm_state=64. Mamba2 backbone + one *shared* attention block applied every
6 Mamba2 layers over concat(hidden, initial-embedding) at width 2d
[arXiv:2411.15242] (per-application LoRA adapters are omitted, as in the
reference). Decode state is O(1) per Mamba2 layer + 6 KV rings, one per
application of the shared block."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab_size=32000, rope_theta=1e4,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid_attn_every=6, hybrid_attn_d_ff=8192,
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="zamba2-1.2b-reduced", family="hybrid",
    n_layers=4, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=512, vocab_size=512, rope_theta=1e4,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=16,
    hybrid_attn_every=2, hybrid_attn_d_ff=512,
    subquadratic=True, attn_impl="naive", remat=False,
)

register("zamba2-1.2b", CONFIG, REDUCED)
