"""BFP (block floating point) quantization format descriptors.

Counterpart of ``repro.core.formats``: the same GGUF k-quant registry and
the same packed layout, so a payload moves between the two packages byte
for byte. For a weight ``W`` of shape ``(K, N)`` quantized along ``K``,
every payload array keeps ``N`` on the minor axis and packs sub-byte
fields along ``K`` in *slab order*:

    within each super-block of ``R`` rows, the packed array has ``R // F``
    rows (``F`` fields per byte); bit-field ``j`` (shift ``j * bits``) of
    packed row ``p`` holds original row ``j * (R // F) + p``.

The CUDA kernel (``csrc/bfp_matmul.cu``) reads this layout directly.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

SUPER_BLOCK = 256   # weights per super-block (SB) for k-quants
BLOCK16 = 16        # Q2_K/Q3_K/Q6_K sub-block
BLOCK32 = 32        # Q4_K/Q5_K sub-block, Q8_0 block


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Shape/dtype of one packed payload array: (K // k_div, N)."""
    name: str
    k_div: int
    dtype: str


@dataclasses.dataclass(frozen=True)
class QuantFormat:
    name: str
    bits_per_weight: float          # this layout's effective bits/weight
    bits_per_weight_gguf: float     # llama.cpp's, for honest reports
    block: int                      # sub-block size (scale granularity)
    super_block: int                # rows per super-block along K
    arrays: Tuple[ArraySpec, ...]
    is_weight_format: bool = True

    def nbytes(self, K: int, N: int) -> int:
        """Bytes of a packed (K, N) tensor in this layout."""
        return sum((K // a.k_div) * N * getattr(torch, a.dtype).itemsize
                   for a in self.arrays)


# Registry: the same eight weight formats and the Q8_K activation format
# as the reference (bits/weight bookkeeping is explained there).

Q2_K = QuantFormat(
    name="q2_k", bits_per_weight=2.625, bits_per_weight_gguf=2.625,
    block=BLOCK16, super_block=SUPER_BLOCK,
    arrays=(
        ArraySpec("qs", 4, "uint8"),       # 4 x 2-bit quants per byte
        ArraySpec("scales", 16, "uint8"),  # lo nibble: scale, hi nibble: min
        ArraySpec("d", 256, "float16"),    # SB super-scale for scales
        ArraySpec("dmin", 256, "float16"), # SB super-scale for mins
    ))

Q3_K = QuantFormat(
    name="q3_k", bits_per_weight=3.5625, bits_per_weight_gguf=3.4375,
    block=BLOCK16, super_block=SUPER_BLOCK,
    arrays=(
        ArraySpec("qs", 4, "uint8"),       # low 2 bits
        ArraySpec("hmask", 8, "uint8"),    # high bit
        ArraySpec("scales", 16, "uint8"),  # 6-bit scale, stored 0..63
        ArraySpec("d", 256, "float16"),
    ))

Q3_K_O = QuantFormat(
    name="q3_k_o", bits_per_weight=4.3125, bits_per_weight_gguf=4.1875,
    block=BLOCK16, super_block=SUPER_BLOCK,
    arrays=(
        ArraySpec("qs", 4, "uint8"),
        ArraySpec("hmask", 8, "uint8"),
        ArraySpec("scales", 16, "uint8"),
        ArraySpec("d", 256, "float16"),
        ArraySpec("oidx", 32, "uint8"),    # 8 outlier row idx per SB (local)
        ArraySpec("ovals", 32, "float16"), # their fp16 values
    ))

Q4_K = QuantFormat(
    name="q4_k", bits_per_weight=4.625, bits_per_weight_gguf=4.5,
    block=BLOCK32, super_block=SUPER_BLOCK,
    arrays=(
        ArraySpec("qs", 2, "uint8"),
        ArraySpec("scales", 32, "uint8"),
        ArraySpec("mins", 32, "uint8"),
        ArraySpec("d", 256, "float16"),
        ArraySpec("dmin", 256, "float16"),
    ))

Q5_K = QuantFormat(
    name="q5_k", bits_per_weight=5.625, bits_per_weight_gguf=5.5,
    block=BLOCK32, super_block=SUPER_BLOCK,
    arrays=(
        ArraySpec("qs", 2, "uint8"),
        ArraySpec("qh", 8, "uint8"),
        ArraySpec("scales", 32, "uint8"),
        ArraySpec("mins", 32, "uint8"),
        ArraySpec("d", 256, "float16"),
        ArraySpec("dmin", 256, "float16"),
    ))

Q6_K = QuantFormat(
    name="q6_k", bits_per_weight=6.5625, bits_per_weight_gguf=6.5625,
    block=BLOCK16, super_block=SUPER_BLOCK,
    arrays=(
        ArraySpec("ql", 2, "uint8"),
        ArraySpec("qh", 4, "uint8"),
        ArraySpec("scales", 16, "int8"),
        ArraySpec("d", 256, "float16"),
    ))

Q4_0 = QuantFormat(
    name="q4_0", bits_per_weight=4.5, bits_per_weight_gguf=4.5,
    block=BLOCK32, super_block=BLOCK32,
    arrays=(
        ArraySpec("qs", 2, "uint8"),
        ArraySpec("d", 32, "float16"),
    ))

Q8_0 = QuantFormat(
    name="q8_0", bits_per_weight=8.5, bits_per_weight_gguf=8.5,
    block=BLOCK32, super_block=BLOCK32,
    arrays=(
        ArraySpec("qs", 1, "int8"),
        ArraySpec("d", 32, "float16"),
    ))

Q8_K = QuantFormat(
    name="q8_k", bits_per_weight=9.125, bits_per_weight_gguf=9.125,
    block=BLOCK16, super_block=SUPER_BLOCK,
    arrays=(
        ArraySpec("qs", 1, "int8"),
        ArraySpec("d", 256, "float32"),
        ArraySpec("bsums", 16, "int16"),
    ),
    is_weight_format=False)

FORMATS: Dict[str, QuantFormat] = {
    f.name: f for f in (Q2_K, Q3_K, Q3_K_O, Q4_0, Q4_K, Q5_K, Q6_K, Q8_0,
                        Q8_K)
}

PAPER_VARIANTS = ("q2_k", "q3_k")
EXTENDED_VARIANTS = ("q3_k_o", "q4_0", "q4_k", "q5_k", "q6_k", "q8_0")
WEIGHT_VARIANTS = PAPER_VARIANTS + EXTENDED_VARIANTS


def get_format(name: str) -> QuantFormat:
    try:
        return FORMATS[name]
    except KeyError:
        raise KeyError(f"unknown quant format {name!r}; "
                       f"known: {sorted(FORMATS)}") from None


def pick_fallback(name: str, K: int) -> str:
    """llama.cpp behaviour: k-quants need K % 256 == 0; otherwise the tensor
    falls back to a 32-block format (Q8_0 here)."""
    fmt = get_format(name)
    if K % fmt.super_block == 0:
        return name
    if K % 32 == 0:
        return "q8_0"
    raise ValueError(f"K={K} not quantizable (needs K % 32 == 0)")


# ---------------------------------------------------------------------------
# slab pack/unpack over the last two axes (..., K, N); leading axes are a
# layer stack and pass through
# ---------------------------------------------------------------------------

def slab_pack(q: torch.Tensor, bits: int, sb_rows: int) -> torch.Tensor:
    """Pack integers q (..., K, N), values in [0, 2^bits), into bytes
    (..., K // F, N) with F = 8 // bits fields per byte in slab order."""
    F = 8 // bits
    *lead, K, N = q.shape
    if K % sb_rows:
        raise ValueError(f"K={K} is not a multiple of {sb_rows}")
    slab = sb_rows // F
    qq = q.to(torch.uint8).reshape(*lead, K // sb_rows, F, slab, N)
    out = torch.zeros(*lead, K // sb_rows, slab, N, dtype=torch.uint8,
                      device=q.device)
    for j in range(F):
        out |= qq[..., j, :, :] << (bits * j)
    return out.reshape(*lead, K // F, N)


def slab_unpack(packed: torch.Tensor, bits: int, sb_rows: int) -> torch.Tensor:
    """Inverse of slab_pack: (..., K//F, N) bytes -> (..., K, N) uint8."""
    F = 8 // bits
    *lead, Kp, N = packed.shape
    slab = sb_rows // F
    if Kp % slab:
        raise ValueError(f"{Kp} packed rows do not tile slabs of {slab}")
    p = packed.reshape(*lead, Kp // slab, slab, N)
    mask = (1 << bits) - 1
    slabs = [(p >> (bits * j)) & mask for j in range(F)]
    return torch.cat(slabs, dim=-2).reshape(*lead, Kp * F, N)
