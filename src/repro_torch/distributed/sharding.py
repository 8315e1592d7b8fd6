"""Serving-side tensor and expert parallelism: the plan and the shard rules.

Counterpart of the serve half of ``repro.distributed.sharding``. The
training-side rules (parameter, optimizer-state and batch specs, the
activation constraints) are not here: they serve the dry run, which the
port does not have yet.

Rules, as the reference's (one "model" axis of ``size`` ranks):

* attn: wq/wk/wv/wo shard their lanes (the output axis) when the head
  counts and ``d_model`` divide ``size``; the KV cache and the prefix
  cache's page pool then hold only this rank's kv heads (axis 3). A
  fused-qkv layout (gpt2) interleaves q/k/v lanes and stays replicated.
* mlp: gate/up/fc (and ``b_fc``) shard the ffn hidden, down/proj the
  ``d_model`` output, when ``d_ff`` and ``d_model`` divide ``size``.
* moe_ep: plain MoE expert stacks shard their expert axis when
  ``n_experts`` divides ``size``; each rank computes its own experts'
  products and one tiled all-gather assembles the output buffers. Packed
  (E*K-stacked) expert stacks keep a replicated payload; the compute path
  slices this rank's experts out of them.
* ``matmul`` picks the projection datapath: "padded" zero-embeds the
  local lanes into a full-width weight and runs the single-device product
  shape (the same bits as tp=1), "sliced" runs the lane-sliced product
  (1/size of the work, within an f32 ulp), "sliced_row" adds the
  row-parallel o-/down-projections (one all-reduce of f32 partials).

Everything else (embeddings, norms, the LM head, biases added after a
gather) is replicated, and every rule that does not divide falls back to
replication.

Where the reference returns a ``PartitionSpec`` pytree, the port returns
a rule per leaf: ``None`` (replicate) or the sharded axis, counted from
the end for parameters (-1 lanes, -2 K rows, -3 experts: a leading
stacked-layer axis passes through) and from the front for caches (3, the
kv-head axis). A packed ``QTensor`` has one rule for all its payloads.
``localize_serve_params`` applies the rules: it returns one rank's views
of the tree (no copies), with each sharded ``QTensor``'s logical (K, N)
cut to the local extent. A lane or row shard of a ``QTensor`` holds the
same bytes as the reference's shard of the same tensor.

``serve_tp`` activates a plan for the model code that runs inside one
rank: it carries the plan, the rank's shard index and the group its
collectives run over (``distributed/group.py``).
"""
from __future__ import annotations

import dataclasses
import threading
from typing import Any, Dict, Optional

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.quantize import QTensor

# the sharded axis of a parameter leaf, counted from its end
LANES, ROWS, EXPERTS = -1, -2, -3
# the sharded axis of a KV payload: k/v (L, B|n_pages, T|page, KH, Dh),
# scales (L, B|n_pages, T|page, KH)
KV_HEADS = 3


@dataclasses.dataclass(frozen=True)
class ServeTPPlan:
    size: int
    axis: str = "model"
    attn: bool = False          # shard heads and the KV cache over kv_heads
    mlp: bool = False           # shard the ffn hidden / down output
    # projection datapath: "padded" | "sliced" | "sliced_row" (module note)
    matmul: str = "padded"
    # row-parallel o-/down-projections under "sliced_row" ("" = off):
    # "packed" -- the weight's K rows shard with its input (whole
    # super-blocks a rank); "dequant" -- the packed payload stays
    # replicated and each rank slices its K rows out of the dequantized
    # weight (K does not split into whole super-blocks)
    attn_row: str = ""
    mlp_row: str = ""
    moe_ep: bool = False        # expert parallelism for MoE stacks


def _row_mode(leaf, size: int) -> str:
    """Row-parallel mode of one down/o-proj weight: "packed" when its K
    rows shard into whole super-blocks, "dequant" for a packed tensor that
    cannot, "" when even a plain tensor's K does not divide."""
    if isinstance(leaf, QTensor):
        K = leaf.shape[0]
        sb = get_format(leaf.variant).super_block
        return "packed" if K % (size * sb) == 0 else "dequant"
    K = leaf.shape[-2]
    return "packed" if K % size == 0 else ""


def make_serve_tp_plan(cfg, size: int, axis: str = "model",
                       matmul: str = "padded", params=None,
                       ep: bool = True) -> ServeTPPlan:
    """Shard-or-replicate decisions for serving ``cfg`` on ``size`` ranks.

    ``params`` (the serve-time tree) lets "sliced_row" choose the
    row-parallel mode of each down/o-proj, which depends on the packed
    variant's super-block; without it the plan keeps the lane-only
    dataflow (and "sliced_row" takes the ring matmul for those). ``ep``
    opts MoE expert stacks into expert-axis sharding where ``n_experts``
    divides ``size``."""
    if matmul not in ("padded", "sliced", "sliced_row"):
        raise ValueError(f"tp matmul must be 'padded', 'sliced' or "
                         f"'sliced_row', got {matmul!r}")
    if size <= 1:
        return ServeTPPlan(size=1, axis=axis, matmul=matmul)
    attn = (not cfg.fused_qkv
            and cfg.n_heads % size == 0
            and cfg.n_kv_heads % size == 0
            and cfg.d_model % size == 0)
    mlp = (cfg.family != "moe"
           and cfg.d_ff % size == 0
           and cfg.d_model % size == 0)
    moe_ep = ep and cfg.family == "moe" and cfg.n_experts % size == 0
    attn_row = mlp_row = ""
    if matmul == "sliced_row" and isinstance(params, dict):
        layers = params.get("layers")
        if (attn and isinstance(layers, dict)
                and isinstance(layers.get("attn"), dict)
                and "wo" in layers["attn"]):
            attn_row = _row_mode(layers["attn"]["wo"], size)
        if (mlp and isinstance(layers, dict)
                and isinstance(layers.get("mlp"), dict)):
            mp = layers["mlp"]
            down = mp.get("w_down", mp.get("c_proj"))
            if down is not None:
                mlp_row = _row_mode(down, size)
    return ServeTPPlan(size=size, axis=axis, attn=attn, mlp=mlp,
                       matmul=matmul, attn_row=attn_row, mlp_row=mlp_row,
                       moe_ep=moe_ep)


# ---------------------------------------------------------------------------
# the active plan inside a rank
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Frame:
    plan: ServeTPPlan
    rank: int
    group: Any


_LOCAL = threading.local()


def _frames() -> list:
    if not hasattr(_LOCAL, "stack"):
        _LOCAL.stack = [None]
    return _LOCAL.stack


class serve_tp:
    """Activates ``plan`` for the model code run inside it on rank
    ``rank`` of ``group`` (a ``distributed.group.TPGroup``, whose
    collectives the projections call). Reentrant: each ``__enter__``
    pushes a frame and each ``__exit__`` pops back to its own depth. The
    stack is per thread (a front end drives its engine from a thread of
    its own)."""

    def __init__(self, plan: ServeTPPlan, rank: int = 0, group=None):
        if not 0 <= rank < max(plan.size, 1):
            raise ValueError(f"rank {rank} outside a plan of size "
                             f"{plan.size}")
        if plan.size > 1 and group is None:
            raise ValueError("a plan of size > 1 needs the group its "
                             "collectives run over")
        self.frame = _Frame(plan, rank, group)
        self._depths = []

    def __enter__(self):
        stack = _frames()
        stack.append(self.frame)
        self._depths.append(len(stack))
        return self

    def __exit__(self, *exc):
        if not self._depths:
            raise RuntimeError("serve_tp.__exit__ without matching "
                               "__enter__")
        del _frames()[self._depths.pop() - 1:]
        return False


def _frame() -> Optional[_Frame]:
    return _frames()[-1]


def serve_tp_plan() -> Optional[ServeTPPlan]:
    f = _frame()
    return None if f is None else f.plan


def serve_tp_rank() -> int:
    f = _frame()
    return 0 if f is None else f.rank


def serve_tp_group():
    f = _frame()
    return None if f is None else f.group


# ---------------------------------------------------------------------------
# per-leaf rules
# ---------------------------------------------------------------------------

_SERVE_ATTN_LANES = ("wq", "wk", "wv", "wo")
_SERVE_MLP_LANES = ("w_gate", "w_up", "w_down", "c_fc", "c_proj", "b_fc")


def _serve_lane_sharded(path: str, plan: ServeTPPlan) -> bool:
    parts = path.split("/")
    leaf = parts[-1]
    block = parts[-2] if len(parts) >= 2 else ""
    if block == "attn" and leaf in _SERVE_ATTN_LANES:
        return plan.attn
    # b_fc rides the mlp flag: it adds to the still-local ffn hidden
    # (b_proj adds after the output gather and stays replicated)
    if block == "mlp" and leaf in _SERVE_MLP_LANES:
        return plan.mlp
    return False


def _serve_row_mode(path: str, plan: ServeTPPlan) -> str:
    """Row-parallel mode ("" | "packed" | "dequant") of this leaf."""
    parts = path.split("/")
    leaf = parts[-1]
    block = parts[-2] if len(parts) >= 2 else ""
    if block == "attn" and leaf == "wo" and plan.attn:
        return plan.attn_row
    if block == "mlp" and leaf in ("w_down", "c_proj") and plan.mlp:
        return plan.mlp_row
    return ""


def _ndim(node) -> int:
    if isinstance(node, QTensor):
        return next(iter(node.data.values())).dim()
    return len(node.shape)


def serve_param_specs(params, plan: ServeTPPlan) -> Any:
    """The tree of per-leaf rules for serve-time params: lane-only TP.

    A leaf's rule is ``None`` (replicated) or the axis it shards on,
    counted from the end: ``LANES`` (-1; K rows whole a rank, so no
    super-block straddles ranks), ``ROWS`` (-2; a row-parallel "packed"
    o-/down-proj) or ``EXPERTS`` (-3; a plain MoE stack under EP). A
    row-parallel "dequant" leaf and a packed expert stack replicate."""

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        path = prefix[:-1]
        parts = path.split("/")
        if plan.size <= 1:
            return None
        if (plan.moe_ep and len(parts) >= 2 and parts[-2] == "moe"
                and parts[-1] in ("w_gate", "w_up", "w_down")):
            return None if isinstance(node, QTensor) else EXPERTS
        row = _serve_row_mode(path, plan)
        if row == "packed" and _ndim(node) >= 2:
            return ROWS
        if row or not _serve_lane_sharded(path, plan) or _ndim(node) < 2:
            return None
        return LANES

    return walk(params)


def serve_cache_specs(cache: Dict[str, Any],
                      plan: ServeTPPlan) -> Dict[str, Optional[int]]:
    """Per-entry rules of a decode cache or page pool: the KV payloads and
    their int8 scales shard axis 3 (``KV_HEADS``, the kv heads) when the
    plan shards attention; the position ring and recurrent state
    replicate (``None``)."""
    return {k: (KV_HEADS if plan.size > 1 and plan.attn
                and k in ("k", "v", "k_scale", "v_scale") else None)
            for k in cache}


def _cut(v: torch.Tensor, dim: int, index: int, n_shards: int):
    n = v.shape[dim] // n_shards
    return v.narrow(dim, index * n, n)


def lane_shard_qtensor(t: QTensor, index: int, n_shards: int) -> QTensor:
    """The ``index``-th of ``n_shards`` lane shards of a packed QTensor:
    every payload sliced on its lane (last) axis, K rows whole (views).
    Because packing runs along K, dequantizing a shard gives the matching
    columns of the whole tensor's dequantization."""
    K, N = t.shape
    if N % n_shards:
        raise ValueError(f"N={N} lanes not divisible into {n_shards} "
                         "shards; lane-only TP requires N % shards == 0")
    return QTensor(t.variant, (K, N // n_shards),
                   {k: _cut(v, -1, index, n_shards)
                    for k, v in t.data.items()})


def row_shard_qtensor(t: QTensor, index: int, n_shards: int) -> QTensor:
    """The ``index``-th of ``n_shards`` K-row shards of a packed QTensor:
    every payload sliced on its packed-row (second-to-last) axis (views).
    Legal only where K splits into whole super-blocks a shard (K %
    (n_shards * super_block) == 0); then a shard's dequantization is the
    matching K rows of the whole tensor's."""
    K, N = t.shape
    sb = get_format(t.variant).super_block
    if K % (n_shards * sb):
        raise ValueError(
            f"K={K} rows not divisible into {n_shards} shards of whole "
            f"{sb}-row super-blocks; use the 'dequant' row fallback")
    return QTensor(t.variant, (K // n_shards, N),
                   {k: _cut(v, -2, index, n_shards)
                    for k, v in t.data.items()})


def localize_serve_params(params, specs, size: int, index: int):
    """Rank ``index``'s local views of ``params`` under ``specs`` (from
    ``serve_param_specs``): a sharded leaf becomes its slice on the rule's
    axis (a sharded QTensor with its logical (K, N) cut to match), a
    replicated leaf stays as it is. No tensor is copied."""
    if size <= 1:
        return params

    def fix(p, s):
        if isinstance(p, dict):
            return {k: fix(v, s[k]) for k, v in p.items()}
        if s is None:
            return p
        if isinstance(p, QTensor):
            if s == LANES:
                return lane_shard_qtensor(p, index, size)
            if s == ROWS:
                return row_shard_qtensor(p, index, size)
            raise ValueError(f"no QTensor shard along axis {s}")
        return _cut(p, s, index, size)

    return fix(params, specs)
