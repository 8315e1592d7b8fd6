"""Per-arch MatMul tensor inventories (path, K, N) for size/distribution
accounting (Fig. 1 / Table III) and for walking a model's MatMuls through
the integer datapath. Counterpart of ``benchmarks/shapes.py``, quirks
included (``core/policy.py::summarize`` counts what it lists): an MoE
config lists one expert's MLP a layer (``d_ff``, not its E expert
stacks), mamba2 (``n_heads`` = ``d_ff`` = 0) zero-width attention and MLP
rows beside its real LM head (no in_proj/out_proj), and a hybrid config
every layer as a dense attention + MLP block."""
from repro_torch.configs.base import ModelConfig


def model_matmuls(cfg: ModelConfig, include_embedding: bool = False):
    """One (path, K, N) entry per layer's MatMul, then the LM head."""
    d, L = cfg.d_model, cfg.n_layers
    out = []
    if cfg.family == "gpt2":
        f = cfg.d_ff
        for _ in range(L):
            out += [("layers/attn/c_attn", d, 3 * d),
                    ("layers/attn/c_proj", d, d),
                    ("layers/mlp/c_fc", d, f),
                    ("layers/mlp/c_proj", f, d)]
    else:
        H, KH, Dh, f = cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_ff
        for _ in range(L):
            out += [("layers/attn/wq", d, H * Dh),
                    ("layers/attn/wk", d, KH * Dh),
                    ("layers/attn/wv", d, KH * Dh),
                    ("layers/attn/wo", H * Dh, d),
                    ("layers/mlp/w_gate", d, f),
                    ("layers/mlp/w_up", d, f),
                    ("layers/mlp/w_down", f, d)]
    out.append(("lm_head", d, cfg.vocab_size))
    if include_embedding:
        out.append(("wte", d, cfg.vocab_size))
    return out
