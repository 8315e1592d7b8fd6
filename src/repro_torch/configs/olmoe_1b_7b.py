"""olmoe-1b-7b [moe]: 16L d=2048 16H (GQA kv=16) per-expert d_ff=1024
vocab=50304, MoE 64 experts top-8 [arXiv:2409.02060].

QK-norm on q and k, as OLMoE. The port serves it on one device; the
reference's expert parallelism (64 % 16 == 0) waits for the port's
tensor parallelism."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1024, vocab_size=50304, rope_theta=1e4,
    n_experts=64, n_experts_active=8, moe_d_ff=1024,
    qk_norm=True,               # OLMoE uses QK-norm
    subquadratic=False,
)

REDUCED = ModelConfig(
    name="olmoe-1b-7b-reduced", family="moe",
    n_layers=2, d_model=256, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=512, rope_theta=1e4,
    n_experts=4, n_experts_active=2, moe_d_ff=128, qk_norm=True,
    capacity_factor=4.0,        # == n_experts: drop-free for exact tests
    attn_impl="naive", remat=False,
)

register("olmoe-1b-7b", CONFIG, REDUCED)
