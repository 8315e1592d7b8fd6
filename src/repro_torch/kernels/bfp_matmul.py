"""Fused BFP dequant-matmul: the CUDA kernel's wrapper and its plain version.

Counterpart of ``repro.kernels.bfp_matmul`` (``bfp_matmul_pallas``). The
kernel (``csrc/bfp_matmul.cu``, CUDA C++ for sm_90a) reads a
reference-packed ``QTensor`` of any of the eight weight variants as it
is, dequantizes each tile on chip into the tensor cores' fragments and
accumulates in f32; the dequantized weight never reaches device memory.
Its source note gives its bound and design.

The kernel splits K into ``k_splits(K, N)`` parts, a function of the
weight's shape alone, so that a row's value never depends on M. With more
than one part the wrapper hands it an f32 workspace of (S, M, N).

``bfp_matmul_plain`` is the same function in plain PyTorch: dequantize to
f32, round to bf16 and back, one f32 matmul per row, one cast. CPU tensors
take it (the CPU tests use it); on the card it is only the yardstick the
kernel is checked against.

The kernel takes any N: on the card each payload's rows start on 16-byte
boundaries (``core.quantize.QTensor`` pads N to ``lane_stride(N)`` lanes
once, when the tensor is made), and the kernel gets that row stride.

``launches`` counts kernel launches per variant. The wrapper adds one
where it launches and nowhere else, so a run can show that the main path
went through the kernel.

``smem_bytes`` (alias ``vmem_bytes``, the reference's name for its TPU
VMEM budget) is the kernel's on-chip budget on Hopper: the shared memory
of one block of each instantiation the launcher picks (``schedules()``),
computed from the constants of ``csrc/bfp_matmul.cu`` as read from that
file. ``kernel_attributes`` reads an instantiation's real shared memory
and registers a thread on the card (``cuFuncGetAttribute``).
"""
from __future__ import annotations

import ast
import ctypes
import functools
import operator
import re
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.quantize import QTensor, dequantize
from repro_torch.kernels import _build

VARIANTS = ("q2_k", "q3_k", "q3_k_o", "q4_0", "q4_k", "q5_k", "q6_k",
            "q8_0")
launches: Dict[str, int] = {v: 0 for v in VARIANTS}

# output dtype codes of the C interface
_OUT_CODE = {torch.float32: 0, torch.bfloat16: 1}
# payload dtypes the kernel reads, per variant, in argument order
_PAYLOADS = {
    "q2_k": (("qs", torch.uint8, 4), ("scales", torch.uint8, 16),
             ("d", torch.float16, 256), ("dmin", torch.float16, 256)),
    "q3_k": (("qs", torch.uint8, 4), ("hmask", torch.uint8, 8),
             ("scales", torch.uint8, 16), ("d", torch.float16, 256)),
    "q3_k_o": (("qs", torch.uint8, 4), ("hmask", torch.uint8, 8),
               ("scales", torch.uint8, 16), ("d", torch.float16, 256),
               ("oidx", torch.uint8, 32), ("ovals", torch.float16, 32)),
    "q4_0": (("qs", torch.uint8, 2), ("d", torch.float16, 32)),
    "q4_k": (("qs", torch.uint8, 2), ("scales", torch.uint8, 32),
             ("mins", torch.uint8, 32), ("d", torch.float16, 256),
             ("dmin", torch.float16, 256)),
    "q5_k": (("qs", torch.uint8, 2), ("qh", torch.uint8, 8),
             ("scales", torch.uint8, 32), ("mins", torch.uint8, 32),
             ("d", torch.float16, 256), ("dmin", torch.float16, 256)),
    "q6_k": (("ql", torch.uint8, 2), ("qh", torch.uint8, 4),
             ("scales", torch.int8, 16), ("d", torch.float16, 256)),
    "q8_0": (("qs", torch.int8, 1), ("d", torch.float16, 32)),
}


# the kernel's column tile (kBN in csrc/bfp_matmul.cu) and the card's SM
# count (NVIDIA H100 SXM), which set the split along K
BLOCK_N = 128
SMS = 132
SUPER_BLOCK = 256


def k_splits(K: int, N: int) -> int:
    """How many parts the kernel splits K into, from the weight's shape
    alone (never from M): the least divisor S of the 256-row tiles along K
    for which column tiles times S fill the card's SMs at decode, else
    every tile its own part. N = 256, K = 2048: 2 column tiles, S = 8."""
    tiles = -(-K // SUPER_BLOCK)
    cols = -(-N // BLOCK_N)
    for s in range(1, tiles + 1):
        if tiles % s == 0 and cols * s >= SMS:
            return s
    return tiles


def reset_launches() -> None:
    for v in VARIANTS:
        launches[v] = 0


def bfp_matmul_plain(x: torch.Tensor, t: QTensor, *,
                     compute_dtype=torch.bfloat16,
                     out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: (M, K); t: packed (K, N). Returns (M, N) in ``out_dtype``.

    Each row is its own (1, K) @ (K, N) product: BLAS picks its kernel,
    and so its summation order, by M, so one product over all rows would
    make a row's value depend on how many rows share the call. Batched
    admission equals sequential admission only if it does not."""
    out_dtype = out_dtype or x.dtype
    w = dequantize(t, dtype=torch.float32).to(compute_dtype).to(torch.float32)
    xf = x.to(compute_dtype).to(torch.float32)
    rows = [xf[m:m + 1] @ w for m in range(xf.shape[0])]
    out = torch.cat(rows) if rows else xf.new_zeros((0, t.shape[1]))
    return out.to(out_dtype)


def _check(x: torch.Tensor, t: QTensor, compute_dtype, out_dtype):
    if t.variant not in _PAYLOADS:
        raise ValueError(f"the CUDA kernel has no {t.variant!r} variant; it "
                         f"has {VARIANTS}")
    if compute_dtype != torch.bfloat16:
        raise ValueError(f"the kernel computes in bf16, got {compute_dtype}")
    if x.dim() != 2:
        raise ValueError(f"x must be (M, K), got {tuple(x.shape)}")
    if x.dtype not in _OUT_CODE or out_dtype not in _OUT_CODE:
        raise ValueError(f"the kernel takes x and out in float32 or "
                         f"bfloat16, got {x.dtype} -> {out_dtype}")
    if not x.is_cuda:
        raise ValueError("the CUDA kernel needs a CUDA tensor")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    M, K = x.shape
    Kt, N = t.shape
    sb = get_format(t.variant).super_block    # 256, or 32 for q4_0/q8_0
    if K != Kt or K % sb:
        raise ValueError(f"x has K={K}, weight has K={Kt} (must match and "
                         f"be a multiple of {t.variant}'s {sb}-row "
                         "super-block)")
    # the kernel copies 16-byte chunks of packed rows: every payload's rows
    # lie ld elements apart, ld a multiple of 16 (a QTensor made on the
    # card is laid out so, core/quantize.py)
    ld = t.data[_PAYLOADS[t.variant][0][0]].stride(0)
    for name, dtype, kdiv in _PAYLOADS[t.variant]:
        a = t.data[name]
        if a.shape != (K // kdiv, N) or a.dtype != dtype:
            raise ValueError(
                f"{t.variant} payload {name!r} is {tuple(a.shape)} "
                f"{a.dtype}, the kernel takes ({K // kdiv}, {N}) {dtype}")
        if a.device != x.device:
            raise ValueError(f"payload {name!r} must be on {x.device}")
        if a.stride() != (ld, 1) or ld % 16 or a.data_ptr() % 16:
            raise ValueError(
                f"payload {name!r} has strides {a.stride()}: its rows must "
                f"start on 16-byte boundaries, ld={ld} elements apart "
                "(a multiple of 16) like every payload of the tensor")
    return M, K, N, ld


def bfp_matmul_cuda(x: torch.Tensor, t: QTensor, *,
                    compute_dtype=torch.bfloat16,
                    out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch the CUDA kernel on x (M, K) against packed t (K, N) on the
    current stream. Raises on anything the kernel does not take."""
    out_dtype = out_dtype or x.dtype
    M, K, N, ld = _check(x, t, compute_dtype, out_dtype)
    lib = _build.load("bfp_matmul")
    # the kernel reads bf16(x): the cast is the compute-dtype cast of the
    # reference, done once here (free for the bf16 activations of a model)
    xb = x.to(torch.bfloat16)
    if xb.data_ptr() % 16:
        raise ValueError("x is not 16-byte aligned")
    out = torch.empty((M, N), dtype=out_dtype, device=x.device)
    splits = k_splits(K, N)
    # split partials go through a workspace only where the launch spreads
    # the splits over blocks (the kernel folds them in-block otherwise)
    ws = (torch.empty((splits, M, N), dtype=torch.float32, device=x.device)
          if lib.bfp_matmul_spreads_splits(M, N, splits) else None)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [t.data[name].data_ptr() for name, _, _ in _PAYLOADS[t.variant]]
    fn = getattr(lib, f"bfp_matmul_{t.variant}")
    err = fn(xb.data_ptr(), *ptrs, out.data_ptr(), _OUT_CODE[out_dtype],
             None if ws is None else ws.data_ptr(), splits, M, K, N, ld,
             stream)
    if err != 0:
        raise RuntimeError(f"bfp_matmul_{t.variant} launch failed with "
                           f"cudaError_t {err} (M={M}, K={K}, N={N}, "
                           f"splits={splits})")
    launches[t.variant] += 1
    return out


# ---------------------------------------------------------------------------
# the on-chip budget: shared memory and registers of each instantiation
# ---------------------------------------------------------------------------

CU_SOURCE = _build.CSRC_DIR / "bfp_matmul.cu"
SMEM_PER_BLOCK = 227 * 1024     # an H100 block's opt-in shared memory
_ELEM = {"uint8_t": 1, "uint16_t": 2}
# the source's name of each variant's format code (its value is read)
_CODE_NAMES = {"q2_k": "kQ2", "q3_k": "kQ3", "q3_k_o": "kQ3O", "q4_0": "kQ40",
               "q4_k": "kQ4", "q5_k": "kQ5", "q6_k": "kQ6", "q8_0": "kQ80"}
# C's integer operators on ints
_OPS = {ast.Add: operator.add, ast.Sub: operator.sub, ast.Mult: operator.mul,
        ast.Div: operator.floordiv}


def _eval(expr: str, env: Dict[str, int]) -> int:
    """An integer C expression of the source (names, literals, + - * /,
    calls of ``at_least_1``), evaluated over ``env``."""
    def ev(n):
        if isinstance(n, ast.Constant) and isinstance(n.value, int):
            return n.value
        if isinstance(n, ast.Name) and n.id in env:
            return env[n.id]
        if isinstance(n, ast.BinOp) and type(n.op) in _OPS:
            return _OPS[type(n.op)](ev(n.left), ev(n.right))
        if (isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
                and n.func.id == "at_least_1" and len(n.args) == 1):
            return max(ev(n.args[0]), 1)
        raise ValueError(f"{CU_SOURCE.name}: cannot evaluate {expr!r}")
    return ev(ast.parse(expr.replace("F::", "F_"), mode="eval").body)


@functools.lru_cache(maxsize=None)
def _layout():
    """What sets a block's shared memory, read from the CUDA source: the
    namespace constants, each variant's ``Fmt`` rows, the ``Tile``
    members, the two figures of ``smem_bytes()`` and the launcher's token
    tiles (``kTokenGroups``). Raises where the source no longer reads as
    expected."""
    src = CU_SOURCE.read_text()

    def one(pattern, what):
        m = re.search(pattern, src, re.S | re.M)
        if m is None:
            raise ValueError(f"{CU_SOURCE.name}: no {what}")
        return m.group(1)

    consts: Dict[str, int] = {}
    for name, expr in re.findall(r"^constexpr int (k\w+) = ([^;]+);", src,
                                 re.M):
        consts[name] = _eval(expr, consts)
    fmts = {code: {k: int(v) for k, v in re.findall(r"(k\w+) = (\d+)", body)}
            for code, body in re.findall(
                r"struct Fmt<(k\w+)> \{(.*?)\};", src, re.S)}
    members = re.findall(r"alignas\((\d+)\) (\w+) (\w+)\[([^\]]+)\]"
                         r"\[([^\]]+)\];",
                         one(r"struct Tile \{(.*?)\};", "Tile struct"))
    body = one(r"constexpr int smem_bytes\(\) \{(.*?)\n\}", "smem_bytes()")
    tiles, out = (re.search(rf"constexpr int {k} = ([^;]+);", body).group(1)
                  for k in ("kTiles", "kOut"))
    groups = [_eval(g.strip(), consts) for g in one(
        r"^constexpr int kTokenGroups\[\] = \{([^}]*)\};",
        "kTokenGroups").split(",")]
    return dict(consts=consts, fmts=fmts, members=members, tiles=tiles,
                out=out, groups=groups)


def _variant_code(variant: str) -> int:
    """The format code of ``variant`` in the CUDA source."""
    return _layout()["consts"][_CODE_NAMES[variant]]


def schedules() -> List[Tuple[int, bool]]:
    """The launcher's instantiations a variant: (8-token groups in the
    token tile, splits folded in-block), each of the source's
    ``kTokenGroups`` unfolded and the largest folded as well: ((1, False),
    (2, False), (4, False), (8, False), (8, True))."""
    gs = _layout()["groups"]
    return [(g, False) for g in gs] + [(gs[-1], True)]


def smem_bytes(variant: str, groups: int,
               fold: bool = False) -> Dict[str, int]:
    """Shared memory of one block of ``bfp_matmul_kernel<variant, groups,
    fold>`` in bytes, from the source's constants: ``x_tile`` (the bf16
    token rows of one staged 256-row tile), ``w_packed_tile`` (its packed
    payload rows, and the one-row placeholder of each array the variant
    lacks), ``tile`` (``sizeof(Tile)``, padding and alignment
    included), ``out_tile`` (the f32 output tile), ``static`` (0: the
    kernel's shared memory is all dynamic), ``dynamic`` (the launch's:
    two staged tiles or the output tile, whichever is larger) and
    ``total``. The counterpart of the reference's ``vmem_bytes``
    (``kernels/bfp_matmul.py:155``); the folded schedule stages what the
    unfolded one does."""
    if (groups, fold) not in schedules():
        raise ValueError(f"the launcher has no ({groups}, fold={fold}) "
                         f"schedule; it has {schedules()}")
    lay = _layout()
    env = dict(lay["consts"], NG=groups)
    env.update({f"F_{k}": v for k, v in
                lay["fmts"][_CODE_NAMES[variant]].items()})
    size = x_tile = w_packed = 0
    for align, ctype, name, rows, cols in lay["members"]:
        n = _eval(rows, env) * _eval(cols, env) * _ELEM[ctype]
        size = -(-size // int(align)) * int(align) + n
        if name == "x":
            x_tile = n
        else:
            w_packed += n
    align = max(int(m[0]) for m in lay["members"])
    tile = -(-size // align) * align
    sizes = {"sizeof(Tile<VARIANT, NG>)": tile, "sizeof(float)": 4}

    def figure(expr):
        for k, v in sizes.items():
            expr = expr.replace(k, str(v))
        return _eval(expr, env)
    staged, out = figure(lay["tiles"]), figure(lay["out"])
    dynamic = max(staged, out)
    return dict(x_tile=x_tile, w_packed_tile=w_packed, tile=tile,
                staged=staged, out_tile=out, static=0, dynamic=dynamic,
                total=dynamic)


vmem_bytes = smem_bytes      # the reference's name for the on-chip budget


# CUfunction_attribute values (cuda.h)
_CU_ATTRS = {"max_threads": 0, "static_smem": 1, "local_bytes": 3,
             "regs": 4, "max_dynamic_smem": 8}


def kernel_attributes(variant: str, groups: int,
                      fold: bool = False) -> Dict[str, int]:
    """The card's figures of one instantiation, by ``cuFuncGetAttribute``
    on its handle from the loaded library (its dynamic shared memory
    allowed first, as a launch allows it): static and the allowed dynamic
    shared memory, registers a thread, local (spill) bytes a thread and
    the most threads a block. Needs the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_attributes reads the card: no CUDA "
                           "device is available")
    torch.cuda.init()
    lib = _build.load("bfp_matmul")
    fn = ctypes.c_void_p()
    err = lib.bfp_matmul_kernel_handle(_variant_code(variant), groups,
                                       int(fold), ctypes.byref(fn))
    if err != 0 or not fn.value:
        raise RuntimeError(f"no handle for bfp_matmul_kernel<{variant}, "
                           f"{groups}, {fold}>: cudaError_t {err}")
    cuda = ctypes.CDLL("libcuda.so.1")
    out = {}
    for name, attr in _CU_ATTRS.items():
        v = ctypes.c_int()
        res = cuda.cuFuncGetAttribute(ctypes.byref(v), ctypes.c_int(attr),
                                      fn)
        if res != 0:
            raise RuntimeError(f"cuFuncGetAttribute({name}) failed with "
                               f"CUresult {res}")
        out[name] = v.value
    return out


def budget(card: bool = False) -> List[Dict[str, object]]:
    """One row a (variant, schedule): the computed shared memory and, with
    ``card``, the card's figures beside it (``kernel_attributes``)."""
    rows = []
    for v in VARIANTS:
        for g, fold in schedules():
            row = dict(variant=v, groups=g, tokens=8 * g, fold=fold,
                       **smem_bytes(v, g, fold))
            if card:
                row["card"] = kernel_attributes(v, g, fold)
            rows.append(row)
    return rows
