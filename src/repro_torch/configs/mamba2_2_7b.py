"""mamba2-2.7b [ssm]: 64L d=2560 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality) [arXiv:2405.21060].

d_inner = 2*2560 = 5120, head_dim 64 -> 80 SSD heads. Decode state is
O(1) a slot: the conv tail and the (H, P, N) SSM state of each layer."""
from repro_torch.configs.base import ModelConfig, register

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=128,
    subquadratic=True,
)

REDUCED = ModelConfig(
    name="mamba2-2.7b-reduced", family="ssm",
    n_layers=2, d_model=256, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab_size=512,
    ssm_state=16, ssm_head_dim=32, ssm_expand=2, ssm_chunk=16,
    subquadratic=True, remat=False,
)

register("mamba2-2.7b", CONFIG, REDUCED)
