"""granite-moe-3b-a800m [moe]: 32L d=1536 24H (GQA kv=8) per-expert
d_ff=512 vocab=49155, MoE 40 experts top-8."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m", family="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8,
    d_ff=512, vocab_size=49155, rope_theta=1e4,
    n_experts=40, n_experts_active=8, moe_d_ff=512,
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="granite-moe-3b-a800m-reduced", family="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=2,
    d_ff=128, vocab_size=512, rope_theta=1e4,
    n_experts=4, n_experts_active=2, moe_d_ff=128,
    capacity_factor=4.0,        # == n_experts: drop-free for exact tests
    attn_impl="naive", remat=False,
)

register("granite-moe-3b-a800m", CONFIG, REDUCED)
