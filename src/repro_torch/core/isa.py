"""Micro-ISA opcode stream generator + functional simulator (paper Table I).

Counterpart of ``repro.core.isa``. The F-BFQ driver controls the
accelerator with five opcodes sent over AXI-Stream; operands (packed
super-blocks) follow load opcodes inline. The instruction stream is the
reference's exactly (opcodes, config registers, the output-stationary
tiling decision of §III-C), and so is the byte-traffic model
(``SimStats``). The functional simulator executes a stream on torch
tensors on a device (the GPU unless the caller asks for the CPU).

Driver flow (paper §III-C):
  1. 0x01 CONFIG with MatMul dims + weight_type register (Q2_K / Q3_K mode)
  2. if the input matrix fits the input buffer: send it once; otherwise
     output-stationary tiling, streaming weights (0x02) / inputs (0x04)
  3. 0x08 SCHEDULE starts the DSBP on the loaded tile: its activations are
     quantized to Q8_K by ``kernels.ops.q8k_quantize`` (on the card, one
     launch of the CUDA kernel ``csrc/q8k_quant.cu``) and multiplied by
     ``kernels.ref.matmul_q8k_ref``
  4. 0x10 STORE drains the accumulator back to main memory
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.quantize import QTensor
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as _ops
from repro_torch.kernels import ref as _ref


class Op(enum.IntEnum):
    CONFIG = 0x01
    LOAD_W = 0x02
    LOAD_I = 0x04
    SCHEDULE = 0x08
    STORE = 0x10


@dataclasses.dataclass
class Insn:
    op: Op
    # CONFIG operands
    dims: Optional[Tuple[int, int, int]] = None      # (M, K, N)
    weight_type: Optional[str] = None                # "q2_k" | "q3_k" | ...
    n_sbs: Optional[int] = None                      # SBs per load (0x01 cfg)
    # LOAD operands: half-open tile ranges
    k_range: Optional[Tuple[int, int]] = None
    n_range: Optional[Tuple[int, int]] = None
    m_range: Optional[Tuple[int, int]] = None


def qtensor_tile(t: QTensor, k0: int, k1: int, n0: int, n1: int) -> QTensor:
    """Slice a packed tensor along (K, N) into views; k0/k1 must be
    SB-aligned."""
    fmt = get_format(t.variant)
    sb = fmt.super_block
    if k0 % sb or k1 % sb:
        raise ValueError(f"K range ({k0}, {k1}) is not aligned to the "
                         f"{sb}-row super-block")
    kdiv = {a.name: a.k_div for a in fmt.arrays}
    data = {name: arr[k0 // kdiv[name]: k1 // kdiv[name], n0:n1]
            for name, arr in t.data.items()}
    return QTensor(t.variant, (k1 - k0, n1 - n0), data)


@dataclasses.dataclass
class TilingPlan:
    tile_m: int
    tile_n: int
    tile_k: int
    whole_input: bool     # paper: input fits in input buffer -> send once


def plan_tiling(M: int, K: int, N: int, variant: str,
                input_buf_bytes: int = 1 << 20,
                weight_buf_bytes: int = 1 << 20,
                tile_m: int = 128, tile_n: int = 256,
                x_itemsize: int = 4) -> TilingPlan:
    """Output-stationary tiling decision (paper §III-C / driver step ii)."""
    fmt = get_format(variant)
    sb = fmt.super_block
    whole_input = M * K * x_itemsize <= input_buf_bytes
    tk = K
    # shrink K tile until the packed weight tile fits the weight buffer
    while fmt.nbytes(tk, min(tile_n, N)) > weight_buf_bytes and tk > sb:
        tk = max(sb, tk // 2 // sb * sb)
    return TilingPlan(tile_m=min(tile_m, M), tile_n=min(tile_n, N),
                      tile_k=tk, whole_input=whole_input)


def generate_stream(M: int, K: int, N: int, variant: str,
                    plan: Optional[TilingPlan] = None) -> List[Insn]:
    """Driver: emit the opcode stream for one MatMul (paper Table I)."""
    plan = plan or plan_tiling(M, K, N, variant)
    fmt = get_format(variant)
    ins: List[Insn] = [Insn(Op.CONFIG, dims=(M, K, N), weight_type=variant,
                            n_sbs=plan.tile_k // fmt.super_block)]
    if plan.whole_input:
        ins.append(Insn(Op.LOAD_I, m_range=(0, M), k_range=(0, K)))
    for n0 in range(0, N, plan.tile_n):
        n1 = min(N, n0 + plan.tile_n)
        for m0 in range(0, M, plan.tile_m):
            m1 = min(M, m0 + plan.tile_m)
            # output-stationary: sweep K for a fixed output tile
            for k0 in range(0, K, plan.tile_k):
                k1 = min(K, k0 + plan.tile_k)
                ins.append(Insn(Op.LOAD_W, k_range=(k0, k1), n_range=(n0, n1)))
                if not plan.whole_input:
                    ins.append(Insn(Op.LOAD_I, m_range=(m0, m1),
                                    k_range=(k0, k1)))
                ins.append(Insn(Op.SCHEDULE))
            ins.append(Insn(Op.STORE, m_range=(m0, m1), n_range=(n0, n1)))
    return ins


@dataclasses.dataclass
class SimStats:
    weight_bytes: int = 0
    input_bytes: int = 0
    output_bytes: int = 0
    schedules: int = 0

    @property
    def total_stream_bytes(self):
        return self.weight_bytes + self.input_bytes + self.output_bytes


class FBFQSimulator:
    """Functional model of the accelerator executing an opcode stream.

    State mirrors Fig. 3/4: config registers, weight/input SB caches,
    an fp32 accumulator. The DSBP compute step uses the llama.cpp-exact
    integer datapath (``ref.matmul_q8k_ref`` on Q8_K activations) for
    q2_k/q3_k and the dequant datapath otherwise. ``x`` is an f32 tensor
    on the device the weights lie on; the simulation runs there.
    """

    def __init__(self, x: torch.Tensor, w: QTensor, use_int_datapath=True):
        self.x = x.to(torch.float32)
        self.w = w
        self.use_int = use_int_datapath and w.variant in ("q2_k", "q3_k")
        self.cfg: Optional[Insn] = None
        self.w_tile: Optional[QTensor] = None
        self.x_tile: Optional[torch.Tensor] = None
        self.x_rng = None
        self.w_rng = None
        self.out: Optional[torch.Tensor] = None
        self._accs: Dict[Tuple[Tuple[int, int], Tuple[int, int]],
                         torch.Tensor] = {}
        self.stats = SimStats()

    def run(self, stream: List[Insn]) -> torch.Tensor:
        for ins in stream:
            getattr(self, f"_op_{ins.op.name.lower()}")(ins)
        if self.out is None:
            raise ValueError("the stream has no CONFIG, so nothing was "
                             "stored")
        return self.out

    # -- opcode handlers ----------------------------------------------------
    def _op_config(self, ins: Insn):
        if ins.weight_type != self.w.variant:
            raise ValueError(f"weight_type register {ins.weight_type!r} "
                             f"does not match the weights' {self.w.variant!r}")
        self.cfg = ins
        M, K, N = ins.dims
        self.out = torch.zeros((M, N), dtype=torch.float32,
                               device=self.x.device)
        self._accs = {}

    def _op_load_w(self, ins: Insn):
        k0, k1 = ins.k_range
        n0, n1 = ins.n_range
        self.w_tile = qtensor_tile(self.w, k0, k1, n0, n1)
        self.w_rng = (ins.k_range, ins.n_range)
        self.stats.weight_bytes += self.w_tile.nbytes

    def _op_load_i(self, ins: Insn):
        m0, m1 = ins.m_range
        k0, k1 = ins.k_range
        self.x_tile = self.x[m0:m1, k0:k1]
        self.x_rng = (ins.m_range, ins.k_range)
        # Q8_K stream density: ~9.125 bits/value (qs + d + bsums)
        self.stats.input_bytes += int(self.x_tile.numel() * 9.125 / 8)

    def _op_schedule(self, ins: Insn):
        if self.w_tile is None or self.x_tile is None:
            raise ValueError("SCHEDULE before both a weight and an input "
                             "tile were loaded")
        (k0w, k1w), (n0, n1) = self.w_rng
        (m0, m1), (k0x, k1x) = self.x_rng
        # align input slice to the weight tile's K range
        xs = (self.x[m0:m1, k0w:k1w] if (k0x, k1x) != (k0w, k1w)
              else self.x_tile)
        if self.use_int:
            qx = _ops.q8k_quantize(xs)
            part = _ref.matmul_q8k_ref(qx, self.w_tile)
        else:
            part = _ref.matmul_ref(xs, self.w_tile)
        key = ((m0, m1), (n0, n1))
        acc = self._accs.get(key)
        self._accs[key] = part if acc is None else acc + part
        self.stats.schedules += 1

    def _op_store(self, ins: Insn):
        m0, m1 = ins.m_range
        n0, n1 = ins.n_range
        self.out[m0:m1, n0:n1] = self._accs.pop(((m0, m1), (n0, n1)))
        self.stats.output_bytes += (m1 - m0) * (n1 - n0) * 4


def run_matmul(x, w: QTensor, plan: Optional[TilingPlan] = None,
               use_int_datapath: bool = True, device="cuda"):
    """Convenience: driver + simulator for one MatMul on ``device``; x is
    an (M, K) array or tensor. Returns (out (M, N) f32 tensor, stats)."""
    dev = resolve_device(device)
    x = torch.as_tensor(x, dtype=torch.float32, device=dev)
    w = w.to(dev)
    M, K = x.shape
    Kt, N = w.shape
    if K != Kt:
        raise ValueError(f"x has K={K}, the weights K={Kt}")
    stream = generate_stream(M, K, N, w.variant, plan)
    sim = FBFQSimulator(x, w, use_int_datapath=use_int_datapath)
    out = sim.run(stream)
    return out, sim.stats
