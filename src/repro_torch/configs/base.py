"""Model/config system: architecture descriptors and registry.

Counterpart of ``repro.configs.base``. ``ModelConfig`` mirrors the
reference field by field (the tests check the mirror), so a config moves
between the two packages by value. Each arch module registers its full
config and a ``REDUCED`` same-family config for CPU tests. The port has
the dense llama family whole (``llama3.2-1b`` with its tied LM head,
``qwen3-1.7b`` with qk-norm, ``phi3-mini-3.8b``, ``h2o-danube-1.8b``
with its sliding window, and the paper's ``tinyllama-1.1b`` and
``mobilellama-1.4b``), the gpt2 family (``gpt2-paper``), the MoE
family (``olmoe-1b-7b``, ``granite-moe-3b-a800m``), the recurrent
families (``mamba2-2.7b``, ssm; ``zamba2-1.2b``, hybrid) and the two
embedding-input families (``qwen2-vl-72b``, vlm with M-RoPE;
``musicgen-large``, audio with sinusoidal positions): every arch of the
reference.

``ShapeConfig`` and ``SHAPES`` are the reference's four dry-run cells;
``input_specs`` gives a cell's model inputs as shape-only stand-ins
(tensors on the meta device, which hold no memory).
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Optional, Tuple

import torch

FAMILIES: Tuple[str, ...] = (
    "dense", "gpt2", "moe", "ssm", "hybrid", "vlm", "audio")


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                 # 0 -> d_model // n_heads

    # attention
    rope_theta: float = 1e6
    qk_norm: bool = False
    sliding_window: Optional[int] = None
    pos_emb: str = "rope"           # rope | mrope | sincos | learned
    mrope_sections: Tuple[int, int, int] = (16, 24, 24)
    attn_logit_softcap: Optional[float] = None

    # block structure
    norm_type: str = "rmsnorm"      # rmsnorm | layernorm
    act: str = "swiglu"             # swiglu | gelu
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    fused_qkv: bool = False         # gpt2-style c_attn

    # MoE
    n_experts: int = 0
    n_experts_active: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25

    # SSM (mamba2 / zamba2)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    ssm_conv_width: int = 4
    ssm_groups: int = 1

    # hybrid: shared attention block applied every k SSM layers (zamba2)
    hybrid_attn_every: int = 0
    hybrid_attn_d_ff: int = 0

    # frontend
    embed_input: bool = True        # False: the caller provides embeddings
    max_position: int = 1 << 20

    # runtime knobs
    dtype: str = "bfloat16"
    attn_impl: str = "auto"         # naive | blockwise | fused | auto
    attn_q_chunk: int = 1024
    attn_kv_chunk: int = 1024
    kernel_impl: str = "auto"       # cuda | torch | ref | auto (kernels/ops.py)
    remat: bool = True
    scan_unroll: bool = False
    ssd_unroll: bool = True
    loss_chunk: int = 2048
    kv_cache_quant: bool = False    # int8 KV cache
    subquadratic: bool = False

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(
                f"unknown model family {self.family!r}; known: {FAMILIES}")
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


_TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
                 "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; known: "
                         f"{sorted(_TORCH_DTYPES)}") from None


ARCH_IDS = (
    "qwen2-vl-72b", "llama3.2-1b", "qwen3-1.7b", "phi3-mini-3.8b",
    "h2o-danube-1.8b", "granite-moe-3b-a800m", "olmoe-1b-7b",
    "musicgen-large", "zamba2-1.2b", "mamba2-2.7b",
    # the paper's own evaluation models (Table III/IV)
    "gpt2-paper", "tinyllama-1.1b", "mobilellama-1.4b",
)

_MODULE_FOR = {i: i.replace("-", "_").replace(".", "_") for i in ARCH_IDS}
_REGISTRY: Dict[str, "ArchSpec"] = {}


@dataclasses.dataclass(frozen=True)
class ArchSpec:
    config: ModelConfig
    reduced: ModelConfig            # CPU smoke-test config, same family


def register(arch_id: str, config: ModelConfig, reduced: ModelConfig):
    _REGISTRY[arch_id] = ArchSpec(config, reduced)


def get_arch(arch_id: str, reduced: bool = False) -> ModelConfig:
    if arch_id not in _REGISTRY:
        mod = _MODULE_FOR.get(arch_id)
        if mod is None:
            raise KeyError(f"unknown arch {arch_id!r}; ported: {ARCH_IDS}")
        importlib.import_module(f"repro_torch.configs.{mod}")
    spec = _REGISTRY[arch_id]
    return spec.reduced if reduced else spec.config


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether an (arch x shape) cell runs, with the reference's reason
    where it does not."""
    if shape.name == "long_500k" and not cfg.subquadratic:
        return False, ("pure full-attention arch: 524k-token decode needs "
                       "sub-quadratic attention (skip per DESIGN.md §4)")
    return True, ""


def shape_only(shape, dtype: torch.dtype) -> torch.Tensor:
    """A stand-in of ``shape`` and ``dtype`` that holds no memory."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig,
                shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Shape-only stand-ins for every model input of this cell, the
    reference's shapes and dtypes. The modality frontends of vlm/audio are
    stubs: embeddings replace the token ids."""
    B, S = shape.global_batch, shape.seq_len
    dt, i32 = torch_dtype(cfg.dtype), torch.int32
    specs: Dict[str, torch.Tensor] = {}
    if shape.kind not in ("train", "prefill", "decode"):
        raise ValueError(shape.kind)
    if shape.kind == "decode":
        # one new token against a cache of seq_len
        if cfg.embed_input:
            specs["tokens"] = shape_only((B,), i32)
        else:
            specs["embeds"] = shape_only((B, cfg.d_model), dt)
        specs["position"] = shape_only((B,), i32)
        return specs
    if cfg.embed_input:
        specs["tokens"] = shape_only((B, S), i32)
    else:
        specs["embeds"] = shape_only((B, S, cfg.d_model), dt)
    if shape.kind == "train":
        specs["labels"] = shape_only((B, S), i32)
    if cfg.pos_emb == "mrope":
        specs["positions"] = shape_only((3, B, S), i32)
    return specs
