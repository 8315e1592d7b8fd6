"""Quantize / dequantize for the GGUF k-quant family, in PyTorch.

Counterpart of ``repro.core.quantize``. Payloads are bit-exact against
the reference on the CPU and on the card: the arithmetic runs in float32
in the reference's order (``/ qmax``, ``/ 15.0``, ``/ 31.0``, ``/ 63.0``,
``/ 127.0`` as true divisions, multiply by ``_safe_inv``, cast to
float16 last), and ``torch.round`` rounds half to even as ``jnp.round``
does. Every function takes ``(..., K, N)``
weights: leading axes (a stacked layer axis) pass through, which is what
the reference's ``vmap`` over stacked layers gives.

The port has all eight weight variants: the paper's Q2_K and Q3_K, the
extended k-quants Q4_K, Q5_K and Q6_K, the outlier-sidecar Q3_K_O and
the 32-row block formats Q4_0 and Q8_0 (Q8_0 is also the fallback for a K
that is a multiple of 32 and not of 256), and the Q8_K activation format
of the integer datapath (``quantize_q8_k``), the plain version of the
CUDA kernel ``kernels/q8k_quant.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import torch

from repro_torch.core import formats as F
from repro_torch.core.formats import slab_pack, slab_unpack


@dataclasses.dataclass
class QTensor:
    """A (K, N) weight matrix in packed BFP form.

    ``data`` holds the payload arrays named per ``formats.FORMATS[variant]``
    in the reference's structure-of-arrays layout (N on the minor axis).
    A stacked tensor keeps its leading layer axis on every payload while
    ``shape`` stays the per-layer logical (K, N); ``layer(i)`` views one
    layer without copying.

    On the card every payload row starts on a 16-byte boundary, as the
    CUDA matmul's 16-byte copies need: where N is not a multiple of 16
    (gpt2's 50257-lane LM head), a payload is laid out once, when the
    QTensor is made, as the ``[..., :N]`` view of a buffer whose rows are
    padded to ``lane_stride(N)`` lanes. The logical payload and its bytes
    stay the reference's.
    """
    variant: str
    shape: Tuple[int, int]
    data: Dict[str, torch.Tensor]

    def __post_init__(self):
        N = self.shape[1]
        if N % 16 and any(v.is_cuda and v.stride(-2) % 16
                          for v in self.data.values()):
            self.data = {k: _lane_padded(v) for k, v in self.data.items()}

    @property
    def nbytes(self) -> int:
        return sum(v.numel() * v.element_size() for v in self.data.values())

    @property
    def bits_per_weight(self) -> float:
        K, N = self.shape
        return self.nbytes * 8.0 / (K * N)

    @property
    def num_layers(self) -> int:
        """Length of the leading stack axis (1 for an unstacked tensor)."""
        v = next(iter(self.data.values()))
        return v.shape[0] if v.dim() == 3 else 1

    def layer(self, i: int) -> "QTensor":
        return QTensor(self.variant, self.shape,
                       {k: v[i] for k, v in self.data.items()})

    def to(self, device) -> "QTensor":
        return QTensor(self.variant, self.shape,
                       {k: v.to(device) for k, v in self.data.items()})


def lane_stride(N: int) -> int:
    """Row stride, in elements, of a payload of N lanes on the card."""
    return -(-N // 16) * 16


def _lane_padded(v: torch.Tensor) -> torch.Tensor:
    N = v.shape[-1]
    buf = torch.zeros(*v.shape[:-1], lane_stride(N), dtype=v.dtype,
                      device=v.device)
    buf[..., :N] = v
    return buf[..., :N]


def _nearest(x):
    # round half to even, as jnp.round does in the reference
    return torch.round(x)


def _div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c, correctly rounded on every device. PyTorch's CUDA division by
    a Python (CPU) scalar multiplies by the scalar's reciprocal, which is
    off by one ulp for some x (c = 31.0, say), and the reference divides;
    a divisor tensor on x's device takes the true division."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def _safe_inv(x):
    pos = x > 0
    return torch.where(pos, 1.0 / torch.where(pos, x, torch.ones_like(x)),
                       torch.zeros_like(x))


def _check_k(w: torch.Tensor, rows: int = 256) -> Tuple[int, int]:
    K, N = w.shape[-2], w.shape[-1]
    if K % rows:
        raise ValueError(f"K={K} is not a multiple of the {rows}-row "
                         "super-block")
    return K, N


# ---------------------------------------------------------------------------
# Q2_K
# ---------------------------------------------------------------------------

def quantize_q2_k(w: torch.Tensor) -> QTensor:
    K, N = _check_k(w)
    lead = w.shape[:-2]
    nsb = K // 256
    x = w.to(torch.float32).reshape(*lead, nsb, 16, 16, N)   # (sb, blk, in, N)
    bmax = x.amax(dim=-2)
    bmin = x.amin(dim=-2)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    min_f = torch.maximum(zero, -bmin)                       # (sb, 16, N) >= 0
    scale_f = _div(torch.maximum(bmax + min_f, zero), 3.0)
    d = _div(scale_f.amax(dim=-2), 15.0)                   # (sb, N)
    dmin = _div(min_f.amax(dim=-2), 15.0)
    sc_q = torch.clamp(_nearest(scale_f * _safe_inv(d).unsqueeze(-2)), 0, 15)
    m_q = torch.clamp(_nearest(min_f * _safe_inv(dmin).unsqueeze(-2)), 0, 15)
    eff_sc = d.unsqueeze(-2) * sc_q                          # (sb, 16, N)
    eff_mn = dmin.unsqueeze(-2) * m_q
    q = torch.clamp(_nearest((x + eff_mn.unsqueeze(-2))
                             * _safe_inv(eff_sc).unsqueeze(-2)), 0, 3)
    qs = slab_pack(q.reshape(*lead, K, N), 2, 256)
    scales = (sc_q.to(torch.uint8) | (m_q.to(torch.uint8) << 4)).reshape(
        *lead, K // 16, N)
    return QTensor("q2_k", (K, N), dict(
        qs=qs, scales=scales,
        d=d.to(torch.float16), dmin=dmin.to(torch.float16)))


def dequantize_q2_k(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    K, N = t.shape
    nsb = K // 256
    lead = t.data["d"].shape[:-2]
    q = slab_unpack(t.data["qs"], 2, 256).reshape(
        *lead, nsb, 16, 16, N).to(torch.float32)
    sc = (t.data["scales"] & 0xF).reshape(*lead, nsb, 16, N).to(torch.float32)
    mn = (t.data["scales"] >> 4).reshape(*lead, nsb, 16, N).to(torch.float32)
    d = t.data["d"].to(torch.float32).unsqueeze(-2)          # (sb, 1, N)
    dmin = t.data["dmin"].to(torch.float32).unsqueeze(-2)
    w = (d * sc).unsqueeze(-2) * q - (dmin * mn).unsqueeze(-2)
    return w.reshape(*lead, K, N).to(dtype)


# ---------------------------------------------------------------------------
# Q3_K
# ---------------------------------------------------------------------------

def quantize_q3_k(w: torch.Tensor) -> QTensor:
    K, N = _check_k(w)
    lead = w.shape[:-2]
    nsb = K // 256
    x = w.to(torch.float32).reshape(*lead, nsb, 16, 16, N)
    amax = x.abs().amax(dim=-2)                              # (sb, 16, N)
    scale_f = _div(amax, 4.0)
    d = _div(scale_f.amax(dim=-2), 31.0)                   # (sb, N)
    sc_q = torch.clamp(_nearest(scale_f * _safe_inv(d).unsqueeze(-2)), 0, 31)
    eff = d.unsqueeze(-2) * sc_q
    q = torch.clamp(_nearest(x * _safe_inv(eff).unsqueeze(-2)), -4, 3) + 4
    q = q.reshape(*lead, K, N).to(torch.uint8)               # [0, 7]
    qs = slab_pack(q & 3, 2, 256)
    hmask = slab_pack(q >> 2, 1, 256)
    scales = (sc_q + 32).to(torch.uint8).reshape(*lead, K // 16, N)
    return QTensor("q3_k", (K, N), dict(
        qs=qs, hmask=hmask, scales=scales, d=d.to(torch.float16)))


def dequantize_q3_k(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    K, N = t.shape
    nsb = K // 256
    lead = t.data["d"].shape[:-2]
    lo = slab_unpack(t.data["qs"], 2, 256)
    hi = slab_unpack(t.data["hmask"], 1, 256)
    q = (lo + (hi << 2)).to(torch.float32) - 4.0             # [-4, 3]
    q = q.reshape(*lead, nsb, 16, 16, N)
    sc = t.data["scales"].to(torch.float32).reshape(*lead, nsb, 16, N) - 32.0
    d = t.data["d"].to(torch.float32).unsqueeze(-2)
    w = (d * sc).unsqueeze(-2) * q
    return w.reshape(*lead, K, N).to(dtype)


# ---------------------------------------------------------------------------
# Q4_K / Q5_K (affine, 32-row blocks, 6-bit scales and mins)
# ---------------------------------------------------------------------------

def _quantize_q45(w: torch.Tensor, variant: str, qmax: int) -> QTensor:
    K, N = _check_k(w)
    lead = w.shape[:-2]
    nsb = K // 256
    x = w.to(torch.float32).reshape(*lead, nsb, 8, 32, N)    # (sb, blk, in, N)
    bmax = x.amax(dim=-2)
    bmin = x.amin(dim=-2)
    zero = torch.zeros((), dtype=torch.float32, device=w.device)
    min_f = torch.maximum(zero, -bmin)                       # (sb, 8, N) >= 0
    scale_f = _div(torch.maximum(bmax + min_f, zero), qmax)
    d = _div(scale_f.amax(dim=-2), 63.0)                   # (sb, N)
    dmin = _div(min_f.amax(dim=-2), 63.0)
    sc_q = torch.clamp(_nearest(scale_f * _safe_inv(d).unsqueeze(-2)), 0, 63)
    m_q = torch.clamp(_nearest(min_f * _safe_inv(dmin).unsqueeze(-2)), 0, 63)
    eff_sc = d.unsqueeze(-2) * sc_q                          # (sb, 8, N)
    eff_mn = dmin.unsqueeze(-2) * m_q
    q = torch.clamp(_nearest((x + eff_mn.unsqueeze(-2))
                             * _safe_inv(eff_sc).unsqueeze(-2)), 0, qmax)
    q = q.to(torch.uint8).reshape(*lead, K, N)
    data = dict(
        qs=slab_pack(q & 15, 4, 256),
        scales=sc_q.to(torch.uint8).reshape(*lead, K // 32, N),
        mins=m_q.to(torch.uint8).reshape(*lead, K // 32, N),
        d=d.to(torch.float16), dmin=dmin.to(torch.float16))
    if qmax > 15:
        data["qh"] = slab_pack(q >> 4, 1, 256)
    return QTensor(variant, (K, N), data)


def quantize_q4_k(w: torch.Tensor) -> QTensor:
    return _quantize_q45(w, "q4_k", 15)


def quantize_q5_k(w: torch.Tensor) -> QTensor:
    return _quantize_q45(w, "q5_k", 31)


def dequantize_q45(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    """Q4_K and Q5_K: (d * sc) * q - dmin * mn over 32-row blocks."""
    K, N = t.shape
    nsb = K // 256
    lead = t.data["d"].shape[:-2]
    q = slab_unpack(t.data["qs"], 4, 256)
    if "qh" in t.data:
        q = q + (slab_unpack(t.data["qh"], 1, 256) << 4)
    q = q.to(torch.float32).reshape(*lead, nsb, 8, 32, N)
    sc = t.data["scales"].to(torch.float32).reshape(*lead, nsb, 8, N)
    mn = t.data["mins"].to(torch.float32).reshape(*lead, nsb, 8, N)
    d = t.data["d"].to(torch.float32).unsqueeze(-2)          # (sb, 1, N)
    dmin = t.data["dmin"].to(torch.float32).unsqueeze(-2)
    w = (d * sc).unsqueeze(-2) * q - (dmin * mn).unsqueeze(-2)
    return w.reshape(*lead, K, N).to(dtype)


# ---------------------------------------------------------------------------
# Q6_K (symmetric, 16-row blocks, signed int8 block scales)
# ---------------------------------------------------------------------------

def quantize_q6_k(w: torch.Tensor) -> QTensor:
    K, N = _check_k(w)
    lead = w.shape[:-2]
    nsb = K // 256
    x = w.to(torch.float32).reshape(*lead, nsb, 16, 16, N)
    amax = x.abs().amax(dim=-2)                              # (sb, 16, N)
    scale_f = _div(amax, 32.0)
    d = _div(scale_f.amax(dim=-2), 127.0)                  # (sb, N)
    sc_q = torch.clamp(_nearest(scale_f * _safe_inv(d).unsqueeze(-2)),
                       -128, 127)
    eff = d.unsqueeze(-2) * sc_q
    q = torch.clamp(_nearest(x * _safe_inv(eff).unsqueeze(-2)), -32, 31) + 32
    q = q.reshape(*lead, K, N).to(torch.uint8)               # [0, 63]
    return QTensor("q6_k", (K, N), dict(
        ql=slab_pack(q & 15, 4, 256),
        qh=slab_pack(q >> 4, 2, 256),
        scales=sc_q.to(torch.int8).reshape(*lead, K // 16, N),
        d=d.to(torch.float16)))


def dequantize_q6_k(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    K, N = t.shape
    nsb = K // 256
    lead = t.data["d"].shape[:-2]
    q = (slab_unpack(t.data["ql"], 4, 256)
         + (slab_unpack(t.data["qh"], 2, 256) << 4)).to(torch.float32) - 32.0
    q = q.reshape(*lead, nsb, 16, 16, N)
    sc = t.data["scales"].to(torch.float32).reshape(*lead, nsb, 16, N)
    d = t.data["d"].to(torch.float32).unsqueeze(-2)
    w = (d * sc).unsqueeze(-2) * q
    return w.reshape(*lead, K, N).to(dtype)


# ---------------------------------------------------------------------------
# Q3_K_O: the q3_k base plus an fp16 outlier sidecar. Per 256-row
# super-block and column, the OUTLIERS_PER_SB rows of largest score
# (|w|, times the calibration's per-K activation abs-max when given) are
# kept exactly in fp16 (local row index + value) and zeroed before the
# q3_k fit.
# ---------------------------------------------------------------------------

OUTLIERS_PER_SB = 8


def quantize_q3_k_o(w: torch.Tensor, act_absmax=None) -> QTensor:
    """``act_absmax``: optional (K,) activation abs-max, shared by every
    layer of a stacked weight (the reference tiles one vector per path).

    The rows are chosen with ``torch.topk``. Among exactly equal scores
    its order differs from ``jax.lax.top_k``'s, and between the CPU and
    CUDA: the bytes then differ, and the selected set too if the tie
    straddles the 8th place. Random normal f32 weights do tie at full
    width (2 of 90,112 (super-block, column) pairs at tinyllama's w_gate
    shape), so byte-for-byte checks use tie-free scores."""
    K, N = _check_k(w)
    lead = w.shape[:-2]
    nsb = K // 256
    no = OUTLIERS_PER_SB
    x = w.to(torch.float32).reshape(*lead, nsb, 256, N)
    score = x.abs()
    if act_absmax is not None:
        a = torch.as_tensor(act_absmax, dtype=torch.float32,
                            device=w.device).reshape(nsb, 256)
        score = score * a[:, :, None]
    # top-`no` rows per (super-block, column), in descending score
    _, idx = torch.topk(score.transpose(-1, -2), no, dim=-1)  # (sb, N, no)
    idx = idx.transpose(-1, -2).contiguous()                  # (sb, no, N)
    ovals = torch.gather(x, -2, idx)
    mask = torch.zeros_like(x, dtype=torch.bool).scatter_(-2, idx, True)
    base = torch.where(mask, torch.zeros_like(x), x).reshape(*lead, K, N)
    qt = quantize_q3_k(base)
    return QTensor("q3_k_o", (K, N), dict(
        qt.data,
        oidx=idx.to(torch.uint8).reshape(*lead, K // 32, N),
        ovals=ovals.to(torch.float16).reshape(*lead, K // 32, N)))


def dequantize_q3_k_o(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    K, N = t.shape
    nsb = K // 256
    no = OUTLIERS_PER_SB
    lead = t.data["d"].shape[:-2]
    base = dequantize_q3_k(
        QTensor("q3_k", (K, N),
                {k: t.data[k] for k in ("qs", "hmask", "scales", "d")}))
    idx = t.data["oidx"].to(torch.long).reshape(*lead, nsb, no, N)
    vals = t.data["ovals"].to(torch.float32).reshape(*lead, nsb, no, N)
    w = base.reshape(*lead, nsb, 256, N)
    rows = torch.arange(256, device=w.device)[:, None]
    # compare-select in the reference's order (the indices are distinct)
    for j in range(no):
        sel = rows == idx[..., j:j + 1, :]
        w = torch.where(sel, vals[..., j:j + 1, :], w)
    return w.reshape(*lead, K, N).to(dtype).contiguous()


# ---------------------------------------------------------------------------
# Q4_0 (32-row blocks, symmetric 4-bit, fp16 scale; llama.cpp's sign
# convention d = signed abs-max / -8)
# ---------------------------------------------------------------------------

def quantize_q4_0(w: torch.Tensor) -> QTensor:
    K, N = _check_k(w, 32)
    lead = w.shape[:-2]
    x = w.to(torch.float32).reshape(*lead, K // 32, 32, N)
    imax = torch.argmax(x.abs(), dim=-2, keepdim=True)   # first of equals
    d = _div(torch.gather(x, -2, imax).squeeze(-2), -8.0)  # (K//32, N)
    nz = d != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, d, torch.ones_like(d)),
                      torch.zeros_like(d))
    q = torch.clamp(_nearest(x * inv.unsqueeze(-2)) + 8, 0, 15)
    q = q.to(torch.uint8).reshape(*lead, K, N)
    return QTensor("q4_0", (K, N), dict(
        qs=slab_pack(q, 4, 32), d=d.to(torch.float16)))


def dequantize_q4_0(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    K, N = t.shape
    lead = t.data["d"].shape[:-2]
    q = slab_unpack(t.data["qs"], 4, 32).to(torch.float32) - 8.0
    d = t.data["d"].to(torch.float32).unsqueeze(-2)      # (K//32, 1, N)
    w = d * q.reshape(*lead, K // 32, 32, N)
    return w.reshape(*lead, K, N).to(dtype)


# ---------------------------------------------------------------------------
# Q8_0 (32-row blocks, int8 codes, fp16 scale)
# ---------------------------------------------------------------------------

def quantize_q8_0(w: torch.Tensor) -> QTensor:
    K, N = _check_k(w, 32)
    lead = w.shape[:-2]
    x = w.to(torch.float32).reshape(*lead, K // 32, 32, N)
    d = _div(x.abs().amax(dim=-2), 127.0)                  # (K//32, N)
    q = torch.clamp(_nearest(x * _safe_inv(d).unsqueeze(-2)), -127, 127)
    return QTensor("q8_0", (K, N), dict(
        qs=q.to(torch.int8).reshape(*lead, K, N), d=d.to(torch.float16)))


def dequantize_q8_0(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    K, N = t.shape
    lead = t.data["d"].shape[:-2]
    q = t.data["qs"].to(torch.float32).reshape(*lead, K // 32, 32, N)
    d = t.data["d"].to(torch.float32).unsqueeze(-2)
    return (d * q).reshape(*lead, K, N).to(dtype)


# ---------------------------------------------------------------------------
# Q8_K activations: x (..., K) -> dict(qs int8, d f32, bsums int16)
# ---------------------------------------------------------------------------

def quantize_q8_k(x: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per 256-value super-block of the trailing axis: ``d = amax / 127``
    (a true division), ``qs = clip(round(x * (1 / d)), -127, 127)`` (a
    multiply by the safe reciprocal, as the reference writes it) and the
    16-value block sums of ``qs`` as int16."""
    K = x.shape[-1]
    if K % 256:
        raise ValueError(f"Q8_K needs K % 256 == 0, got K={K}")
    lead = x.shape[:-1]
    xf = x.to(torch.float32).reshape(*lead, K // 256, 256)
    amax = xf.abs().amax(dim=-1)                            # (..., nsb)
    d = _div(amax, 127.0)
    q = torch.clamp(_nearest(xf * _safe_inv(d).unsqueeze(-1)), -127, 127)
    q = q.to(torch.int8)
    bsums = q.to(torch.int32).reshape(*lead, K // 256, 16, 16).sum(-1)
    return dict(qs=q.reshape(*lead, K), d=d,
                bsums=bsums.to(torch.int16).reshape(*lead, K // 16))


def dequantize_q8_k(qx: Dict[str, torch.Tensor],
                    dtype=torch.float32) -> torch.Tensor:
    qs = qx["qs"]
    K = qs.shape[-1]
    lead = qs.shape[:-1]
    q = qs.to(torch.float32).reshape(*lead, K // 256, 256)
    x = q * qx["d"].unsqueeze(-1)
    return x.reshape(*lead, K).to(dtype)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

_QUANTIZE = {"q2_k": quantize_q2_k, "q3_k": quantize_q3_k,
             "q3_k_o": quantize_q3_k_o, "q4_0": quantize_q4_0,
             "q4_k": quantize_q4_k, "q5_k": quantize_q5_k,
             "q6_k": quantize_q6_k, "q8_0": quantize_q8_0}
_DEQUANTIZE = {"q2_k": dequantize_q2_k, "q3_k": dequantize_q3_k,
               "q3_k_o": dequantize_q3_k_o, "q4_0": dequantize_q4_0,
               "q4_k": dequantize_q45, "q5_k": dequantize_q45,
               "q6_k": dequantize_q6_k, "q8_0": dequantize_q8_0}


def quantize_fn(variant: str):
    """The packing function of an already-resolved variant (unknown names
    raise KeyError)."""
    if variant not in _QUANTIZE:
        F.get_format(variant)               # raises KeyError for a typo
        raise ValueError(f"{variant!r} is not a weight format")
    return _QUANTIZE[variant]


def quantize(variant: str, w: torch.Tensor) -> QTensor:
    """Quantize weights (..., K, N) along K. Applies the llama.cpp fallback
    rule (K % 256 != 0 -> q8_0)."""
    return quantize_fn(F.pick_fallback(variant, w.shape[-2]))(w)


def dequantize(t: QTensor, dtype=torch.float32) -> torch.Tensor:
    return _DEQUANTIZE[t.variant](t, dtype=dtype)


def qtensor_spec(variant: str, K: int, N: int) -> QTensor:
    """Shape-only stand-in of a packed (K, N) weight: a QTensor whose
    payloads are meta tensors of the packed shapes and dtypes, nothing
    allocated (the reference's ``ShapeDtypeStruct`` stand-in, for the dry
    run). The llama.cpp fallback applies (K % 256 != 0 -> q8_0)."""
    variant = F.pick_fallback(variant, K)
    fmt = F.get_format(variant)
    if K % fmt.super_block:
        raise ValueError(f"{variant}: K={K} not divisible by super-block "
                         f"{fmt.super_block}")
    data = {a.name: torch.empty((K // a.k_div, N),
                                dtype=getattr(torch, a.dtype), device="meta")
            for a in fmt.arrays}
    return QTensor(variant, (K, N), data)
