"""Sharding rules: the training half (FSDP x TP specs, activation
constraints) and serving-side tensor and expert parallelism.

Counterpart of ``repro.distributed.sharding``.

Training half (the dry run's, ``launch/dryrun.py``). The rules take only
axis names and sizes (``MeshShape``: a ``DeviceMesh`` or anything with
``axis_names`` and ``shape``), so they run with no process group. A spec
is a tuple with one entry per tensor dim: ``None``, an axis name, or a
tuple of axis names (major first), equal to ``tuple(PartitionSpec)`` of
the reference's rule (a one-name tuple is the bare name, as JAX
normalizes it). Conventions, as the reference's:

* data-parallel axes: ("data",) on one pod, ("pod", "data") on several;
  under ``tp_off`` the "model" axis joins them (pure FSDP).
* weights: lanes over "model", K rows over dp (FSDP); the down/out
  projections are row-parallel (K over "model", lanes over dp). MoE
  experts: EP over "model" when E divides it, else per-expert FFN TP.
* packed QTensors (serve): lanes over "model", or, for a row-parallel
  weight, the packed K rows when K % (|model| * 256) == 0; else
  replicated. ``param_specs`` gives a ``QSpec`` (one spec a payload).
* caches: batch over dp, then kv heads over "model" (``kv_shard``: auto,
  heads, head_dim, seq or replicated); B = 1 shards the sequence over dp.

Every rule checks divisibility and degrades to replication.
``named(spec, mesh)`` turns a spec into DTensor placements on a
``DeviceMesh``. The model code's two hooks: ``constrain(x, "dp", None,
"model")`` and ``gather_dp(w)`` (an FSDP weight gathered at its use) are
the identity outside ``activation_axes(mesh)``; inside it a DTensor is
redistributed to the resolved placements. The functions a dry run runs
on each rank's shards are ``launch/partition.py``'s.

Serving half. Rules, as the reference's (one "model" axis of ``size``
ranks):

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

For serving, where the reference returns a ``PartitionSpec`` pytree, the
port returns a rule per leaf: ``None`` (replicate) or the sharded axis,
counted from the end for parameters (-1 lanes, -2 K rows, -3 experts: a
leading stacked-layer axis passes through) and from the front for caches
(3, the kv-head axis). A packed ``QTensor`` has one rule for all its payloads.
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
from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.core.formats import get_format
from repro_torch.core.quantize import QTensor

# ---------------------------------------------------------------------------
# training half: axis roles, parameter / optimizer / batch / cache specs
#
# tp_off() retargets the "model" axis as extra data parallelism (pure
# FSDP); the physical mesh is unchanged, only the role mapping moves. The
# contexts push frames on module-level stacks and each exit pops back to
# its own enter's depth, so they are reentrant and an interleaved exit
# leaves a coherent state, as the reference's.
# ---------------------------------------------------------------------------
_TP_STACK = [False]


class _StackedContext:
    """Reentrant context manager over a module-level frame stack."""

    _stack: list          # subclasses point this at their frame stack

    def __init__(self):
        self._depths = []

    def _frame(self):
        raise NotImplementedError

    def __enter__(self):
        self._stack.append(self._frame())
        self._depths.append(len(self._stack))
        return self

    def __exit__(self, *exc):
        if not self._depths:
            raise RuntimeError(
                f"{type(self).__name__}.__exit__ without matching __enter__")
        del self._stack[self._depths.pop() - 1:]
        return False


class tp_off(_StackedContext):
    def __init__(self):
        super().__init__()
        self._stack = _TP_STACK

    def _frame(self):
        return True


def _tp_is_off() -> bool:
    return _TP_STACK[-1]


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """Axis names and sizes of a mesh, without devices or a process
    group: what the spec rules read (a ``DeviceMesh`` works as well)."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def mesh_shape(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``MeshShape`` or a ``DeviceMesh``."""
    if isinstance(mesh, MeshShape):
        return mesh.shape
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _names(mesh) -> Tuple[str, ...]:
    return tuple(mesh_shape(mesh))


def model_axis(mesh) -> Optional[str]:
    if _tp_is_off() or "model" not in _names(mesh):
        return None
    return "model"


def dp_axes(mesh) -> Tuple[str, ...]:
    names = _names(mesh)
    axes = [a for a in ("pod", "data") if a in names]
    if _tp_is_off() and "model" in names:
        axes.append("model")
    return tuple(axes)


def axis_size(mesh, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_shape(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _div(n: int, mesh, axes) -> bool:
    return n % axis_size(mesh, axes) == 0


def _spec(*dims) -> Tuple:
    """A spec as ``tuple(PartitionSpec(*dims))`` gives it: a one-name
    tuple becomes the bare name, an empty one None."""
    out = []
    for d in dims:
        if isinstance(d, tuple):
            d = d[0] if len(d) == 1 else (d or None)
        out.append(d)
    return tuple(out)


# down/out projections are row-parallel (K over model): their input is
# already model-sharded, so the forward emits one d_model-sized reduction
# instead of gathering the ff-sized hidden (Megatron's pairing with the
# column-parallel up/gate/qkv)
_ROW_PARALLEL = ("w_down", "wo", "c_proj", "out_proj", "proj_out")


def _is_row_parallel(path: str) -> bool:
    return path.split("/")[-1] in _ROW_PARALLEL


def _spec_for_matrix(shape, mesh, path: str, *, fsdp: bool) -> Tuple:
    """(lead..., K, N) weight: column-parallel (N over model, K over dp)
    by default; row-parallel (K over model, N over dp) for down/out."""
    dp, m = dp_axes(mesh), model_axis(mesh)
    dims = [None] * len(shape)
    if _is_row_parallel(path):
        if m and _div(shape[-2], mesh, m):
            dims[-2] = m
        if fsdp and _div(shape[-1], mesh, dp):
            dims[-1] = dp
    else:
        if m and _div(shape[-1], mesh, m):
            dims[-1] = m
        if fsdp and _div(shape[-2], mesh, dp):
            dims[-2] = dp
    return _spec(*dims)


def _spec_for_experts(shape, mesh, path: str, *, fsdp: bool) -> Tuple:
    """(lead..., E, K, N): EP over model if divisible, else FFN-TP."""
    dp, m = dp_axes(mesh), model_axis(mesh)
    if not (m and _div(shape[-3], mesh, m)):
        return _spec_for_matrix(shape, mesh, path, fsdp=fsdp)
    dims = [None] * len(shape)
    dims[-3] = m                                 # EP
    if fsdp and _div(shape[-2], mesh, dp):
        dims[-2] = dp
    return _spec(*dims)


@dataclasses.dataclass(frozen=True)
class QSpec:
    """The specs of a packed QTensor's payloads (the reference gives a
    QTensor whose payloads are PartitionSpecs)."""
    variant: str
    shape: Tuple[int, int]
    data: Dict[str, Tuple]


def param_specs(params, mesh, *, fsdp: bool = True) -> Any:
    """The tree of specs matching ``params`` (tensors, shape-only
    stand-ins or QTensors; a QTensor gives a ``QSpec``)."""

    def walk(node, prefix=""):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        path = prefix[:-1]
        if isinstance(node, QTensor):
            # packed payloads: column-parallel = lanes over model;
            # row-parallel = packed K rows over model, only where every
            # shard holds whole super-blocks, else replicated
            m = model_axis(mesh)
            row = _is_row_parallel(path) and "moe/" not in path
            aligned = m is not None and node.shape[0] % (
                axis_size(mesh, m) * 256) == 0

            def qspec(arr):
                dims = [None] * arr.dim()
                if row:
                    if aligned:
                        dims[-2] = m
                elif m and _div(arr.shape[-1], mesh, m):
                    dims[-1] = m
                return _spec(*dims)
            return QSpec(node.variant, tuple(node.shape),
                         {k: qspec(v) for k, v in node.data.items()})
        shape = tuple(node.shape)
        parts = path.split("/")
        leaf = parts[-1]
        is_norm = (any(p.startswith("ln") or "norm" in p for p in parts)
                   or "norm" in leaf)
        if (len(shape) <= 1 or is_norm
                or leaf.startswith(("conv", "A_log", "D", "dt_bias",
                                    "b_", "bias"))):
            return _spec()              # replicated (stacked norm scales
            # included: their leading dim is the layer axis)
        if "moe/w_" in path and len(shape) >= 3:
            return _spec_for_experts(shape, mesh, path, fsdp=fsdp)
        if leaf in ("wte", "wpe"):
            # vocab over model (a tied head emits vocab-sharded logits),
            # features over dp
            dp, m = dp_axes(mesh), model_axis(mesh)
            row = m if (m and _div(shape[0], mesh, m)) else None
            col = dp if fsdp and _div(shape[1], mesh, dp) else None
            return _spec(*([None] * (len(shape) - 2) + [row, col]))
        return _spec_for_matrix(shape, mesh, path, fsdp=fsdp)

    return walk(params)


def opt_state_specs(pspecs) -> Dict[str, Any]:
    return dict(m=pspecs, v=pspecs, step=_spec())


def batch_specs(batch: Dict[str, Any], mesh) -> Dict[str, Tuple]:
    dp = dp_axes(mesh)
    out = {}
    for k, v in batch.items():
        nd = len(v.shape)
        if k == "positions" and nd == 3:         # (3, B, S) M-RoPE
            out[k] = _spec(None, dp if _div(v.shape[1], mesh, dp) else None,
                           None)
        elif nd >= 1:
            bdp = dp if _div(v.shape[0], mesh, dp) else None
            out[k] = _spec(*((bdp,) + (None,) * (nd - 1)))
        else:
            out[k] = _spec()
    return out


KV_SHARD_MODES = ("auto", "heads", "head_dim", "seq", "replicated")


def cache_specs(cache: Dict[str, Any], mesh,
                kv_shard: str = "auto") -> Dict[str, Tuple]:
    """Decode-cache specs. kv_shard: auto | heads | head_dim | seq |
    replicated ("seq" is the flash-decoding partial-softmax layout)."""
    if kv_shard not in KV_SHARD_MODES:
        raise ValueError(f"kv_shard {kv_shard!r}; known: {KV_SHARD_MODES}")
    dp, m = dp_axes(mesh), model_axis(mesh)

    def bdp(B, T=None):
        """Batch over dp when divisible; else (B = 1 long context) the
        cache sequence over dp."""
        if _div(B, mesh, dp):
            return dp, None
        if T is not None and _div(T, mesh, dp):
            return None, dp
        return None, None

    # one kv mode for k/v and their int8 scales; auto prefers heads, then
    # the sequence (head_dim only when asked: GQA's q heads against a
    # head_dim-sharded cache re-gather the whole cache every step)
    kv_mode = "replicated"
    if "k" in cache and m:
        ks = cache["k"].shape
        kv_mode = kv_shard
        if kv_mode == "auto":
            kv_mode = ("heads" if _div(ks[3], mesh, m)
                       else "seq" if _div(ks[2], mesh, m) else "replicated")

    out: Dict[str, Tuple] = {}
    for k, v in cache.items():
        shape = v.shape
        if k in ("k", "v", "k_scale", "v_scale"):
            # (L|napp, B, T, KH, Dh), scales (L, B, T, KH)
            b_ax, t_ax = bdp(shape[1], shape[2])
            dims = [None, b_ax, t_ax] + [None] * (len(shape) - 3)
            if kv_mode == "heads":
                dims[3] = m
            elif kv_mode == "head_dim" and len(shape) == 5:
                dims[4] = m
            elif kv_mode == "seq" and t_ax is None:
                dims[2] = m
            out[k] = _spec(*dims)
        elif k == "pos":                         # (B, T)
            out[k] = _spec(*bdp(shape[0], shape[1]))
        elif k == "state":                       # (L, B, H, P, N)
            dims = [None, bdp(shape[1])[0], None, None, None]
            if m and _div(shape[2], mesh, m):
                dims[2] = m
            out[k] = _spec(*dims)
        elif k == "conv":                        # (L, B, W-1, C)
            out[k] = _spec(None, bdp(shape[1])[0], None,
                           m if (m and _div(shape[3], mesh, m)) else None)
        else:
            out[k] = _spec()
    return out


def named(spec: Tuple, mesh) -> list:
    """A spec -> the DTensor placements on ``mesh`` (a ``DeviceMesh``):
    mesh dim i is ``Shard(d)`` where tensor dim d's entry names it, else
    ``Replicate()``. A dim sharded over several axes names them major
    first, which is DTensor's order over mesh dims, so the entry must
    follow the mesh's axis order (("pod", "data") does)."""
    from torch.distributed.tensor import Replicate, Shard
    names = _names(mesh)
    placements = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = (entry,) if isinstance(entry, str) else tuple(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in the mesh's "
                             f"axis order {names}")
        for i in idx:
            placements[i] = Shard(d)
    return placements


def local_shape(shape, spec: Tuple, mesh) -> Tuple[int, ...]:
    """One rank's shard shape of a tensor of ``shape`` under ``spec``."""
    return tuple(n // axis_size(mesh, e) for n, e in
                 zip(shape, tuple(spec) + (None,) * (len(shape) - len(spec))))


# ---------------------------------------------------------------------------
# activation constraints inside model code
#
# Model code calls constrain(x, "dp", None, "model") with symbolic axes;
# activation_axes(mesh) resolves them. Outside it constrain returns its
# argument, so every path that does not run a dry run is unchanged.
# ---------------------------------------------------------------------------
_ACT_STACK = [None]


class activation_axes(_StackedContext):
    def __init__(self, mesh):
        super().__init__()
        self._stack = _ACT_STACK
        self.mesh = mesh
        self.dp = dp_axes(mesh)
        self.model = model_axis(mesh)
        self.dp_size = axis_size(mesh, self.dp)
        self.model_size = axis_size(mesh, self.model) if self.model else 1

    def _frame(self):
        return self


def constrain(x, *dims):
    """Redistribute a DTensor to the resolved symbolic axes ('dp',
    'model', None a dim); a dim that does not divide stays unsharded.
    The identity outside ``activation_axes`` and on a plain tensor."""
    act = _ACT_STACK[-1]
    if act is None or not hasattr(x, "redistribute"):
        return x
    resolved = []
    for size, d in zip(x.shape, dims):
        if d == "dp" and act.dp and size % act.dp_size == 0:
            resolved.append(act.dp)
        elif d == "model" and act.model and size % act.model_size == 0:
            resolved.append(act.model)
        else:
            resolved.append(None)
    placements = named(_spec(*resolved), x.device_mesh)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def gather_dp(w):
    """A weight at its use under a dry run: its data-parallel (FSDP)
    shards all-gathered, its "model" sharding kept (the reference's
    convention: "GSPMD all-gathers at use"); in the backward pass the
    gather's gradient is the reduce-scatter of the weight's gradient. The
    identity outside ``activation_axes`` and on a plain tensor."""
    act = _ACT_STACK[-1]
    if act is None or not hasattr(w, "device_mesh"):
        return w
    from torch.distributed.tensor import Replicate
    names = w.device_mesh.mesh_dim_names
    pl = [Replicate() if p.is_shard() and names[i] in act.dp else p
          for i, p in enumerate(w.placements)]
    if pl == list(w.placements):
        return w
    return w.redistribute(w.device_mesh, pl)


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
