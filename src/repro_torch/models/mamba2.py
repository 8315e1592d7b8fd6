"""Mamba2 (SSD -- state-space duality) block: chunked scan + decode
recurrence.

Counterpart of ``repro.models.mamba2``. Prefill and ``forward_seq`` run
the chunked SSD algorithm (quadratic within a chunk, linear across
chunks); decode is the O(1) recurrence. Shapes: d_inner = expand *
d_model; H = d_inner // head_dim heads of size P; state N per head;
n_groups = 1 (B/C shared across heads). ``in_proj`` and ``out_proj`` go
through ``layers.dense``, so through the dequant-matmul kernel when they
are packed.

The reference's ``lax.scan`` over chunks is a Python loop here. Its
products (``CB``, the diagonal block, the chunk state and the
off-diagonal term) run one batch row at a time, at shapes that do not
depend on the batch: cuBLAS picks its batched kernel by the batch count,
so a product over the whole batch could give a row other bits in a
group of four than alone, and batched admission would stop being
token-identical to one request at a time. The elementwise steps run on
the whole batch; they are per element either way.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as Fn

from repro_torch.core import calibrate as CAL
from repro_torch.distributed.sharding import constrain
from repro_torch.models.layers import dense, rmsnorm


def ssm_dims(cfg) -> Dict[str, int]:
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    N = cfg.ssm_state
    conv_ch = d_in + 2 * cfg.ssm_groups * N
    d_proj = 2 * d_in + 2 * cfg.ssm_groups * N + H
    return dict(d_inner=d_in, n_heads=H, state=N, conv_ch=conv_ch,
                d_proj=d_proj, head_dim=cfg.ssm_head_dim)


def _split_proj(zxbcdt, cfg):
    """in_proj's output -> (z, xBC, dt)."""
    dd = ssm_dims(cfg)
    d_in = dd["d_inner"]
    return torch.split(zxbcdt, [d_in, dd["conv_ch"], dd["n_heads"]], dim=-1)


def _softplus(x):
    """log(1 + exp(x)) as the reference's ``jax.nn.softplus`` computes it
    (``logaddexp(x, 0)``), with no threshold."""
    return x.clamp_min(0) + torch.log1p(torch.exp(-x.abs()))


def _taps(hist, conv_w, S: int):
    """sum_i hist[:, i:i+S] * conv_w[i], taps summed in the reference's
    order (i = 0..W-1), elementwise: each row's bits are its own."""
    out = hist[:, 0:S] * conv_w[0]
    for i in range(1, conv_w.shape[0]):
        out = out + hist[:, i:i + S] * conv_w[i]
    return out


def _causal_conv(xBC, conv_w, conv_b, conv_state=None, state_take=None):
    """Depthwise causal conv1d. xBC: (B, S, C); conv_w: (W, C).
    conv_state: (B, W-1, C) previous tail (decode/chunked prefill).
    state_take: optional (B,) count of valid leading columns per row; the
    returned tail then ends at that column, so a row whose prompt ended
    mid-chunk keeps its true tail and a row with 0 valid columns keeps
    ``conv_state`` unchanged (masked batched prefill)."""
    B, S, C = xBC.shape
    W = conv_w.shape[0]
    if conv_state is None:
        pad = xBC.new_zeros((B, W - 1, C))
    else:
        pad = conv_state.to(xBC.dtype)
    xp = torch.cat([pad, xBC], dim=1)                       # (B, S+W-1, C)
    out = _taps(xp, conv_w, S)
    out = out + conv_b.to(out.dtype)
    if state_take is None:
        new_state = xp[:, S:]
    else:
        idx = (state_take.to(torch.long)[:, None]
               + torch.arange(W - 1, device=xBC.device)[None])  # (B, W-1)
        new_state = torch.gather(xp, 1, idx[:, :, None].expand(B, W - 1, C))
    return Fn.silu(out), new_state


def _ssd_chunk_scan(x, dt, A, Bm, Cm, state0, chunk: int):
    """Chunked SSD. x: (B,S,H,P), dt: (B,S,H), A: (H,), Bm/Cm: (B,S,N),
    state0: (B,H,P,N). Returns y (B,S,H,P) f32, state (B,H,P,N) f32."""
    Bsz, S, H, P = x.shape
    Q = min(chunk, S)
    S0 = S
    if S % Q:
        # pad the tail with dt = 0 steps: decay 1 and no input, so the
        # state and every real output are unaffected
        pad = Q - S % Q
        x = Fn.pad(x, (0, 0, 0, 0, 0, pad))
        dt = Fn.pad(dt, (0, 0, 0, pad))
        Bm = Fn.pad(Bm, (0, 0, 0, pad))
        Cm = Fn.pad(Cm, (0, 0, 0, pad))
        S += pad
    f32 = torch.float32
    x, dt, Bm, Cm = (t.to(f32) for t in (x, dt, Bm, Cm))
    Af = A.to(f32)
    ii = torch.arange(Q, device=x.device)
    tri = (ii[:, None] >= ii[None, :])[None, :, :, None]    # (1, i, j, 1)
    state = state0.to(f32)
    ys = []
    for c0 in range(0, S, Q):
        xc, dtc = x[:, c0:c0 + Q], dt[:, c0:c0 + Q]
        Bc, Cc = Bm[:, c0:c0 + Q], Cm[:, c0:c0 + Q]
        acs = torch.cumsum(dtc * Af, dim=1)                 # (B, Q, H)
        # exp of a positive difference above the diagonal may be +inf, and
        # inf * 0 is NaN in a product and in exp's backward: mask the
        # exponent to -inf, whose exp is the same 0, and whose gradient is 0
        decay = torch.exp(torch.where(
            tri, acs[:, :, None] - acs[:, None],
            torch.full((), -torch.inf, dtype=f32, device=x.device)))
        u = dtc[..., None] * xc                             # (B, Q, H, P)
        v = (dtc * torch.exp(acs[:, -1:] - acs))[..., None] * xc
        e_acs = torch.exp(acs)
        y_rows, st_rows = [], []
        for b in range(Bsz):
            CB = Cc[b] @ Bc[b].T                            # (Q, Q)
            scores = (CB[..., None] * decay[b]).permute(2, 0, 1)  # (H, i, j)
            y_diag = torch.bmm(scores, u[b].transpose(0, 1))      # (H, Q, P)
            y_off = torch.matmul(Cc[b], state[b].transpose(1, 2))  # (H, Q, P)
            y_off = y_off * e_acs[b].T[:, :, None]
            y_rows.append((y_diag + y_off).transpose(0, 1))       # (Q, H, P)
            st_rows.append(torch.matmul(v[b].permute(1, 2, 0), Bc[b]))
        state = (state * torch.exp(acs[:, -1])[:, :, None, None]
                 + torch.stack(st_rows))                    # (B, H, P, N)
        ys.append(torch.stack(y_rows))
    y = torch.cat(ys, dim=1)
    return y[:, :S0], state


def mamba2_forward(h, p: Dict, cfg, *, conv_state=None, ssm_state=None,
                   valid=None, impl: str = "auto"):
    """Full-sequence forward (prefill chunk, ``forward_seq``).

    h: (B, S, d_model). Returns (out (B, S, d), (conv_state, ssm_state)).

    valid: optional (B, S) bool -- True on real columns, always a
    contiguous prefix of each row (masked batched prefill). Invalid
    columns never touch the recurrent state: dt is zeroed after the
    softplus (decay exp(0) = 1 and no input) and the conv tail is gathered
    at each row's last valid column. Outputs at invalid columns are
    garbage and must be ignored by the caller."""
    dd = ssm_dims(cfg)
    Bsz, S, _ = h.shape
    H, P, N = dd["n_heads"], dd["head_dim"], dd["state"]

    CAL.tap("ssm/in_proj", h)
    zxbcdt = dense(h, p["in_proj"], impl=impl)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    xBC, conv_state_new = _causal_conv(
        xBC, p["conv_w"], p["conv_b"], conv_state,
        state_take=None if valid is None else valid.sum(dim=1))
    x, Bm, Cm = torch.split(xBC, [dd["d_inner"], N, N], dim=-1)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    if valid is not None:
        dt = torch.where(valid[..., None], dt, torch.zeros_like(dt))
    A = -torch.exp(p["A_log"].to(torch.float32))
    x = constrain(x.reshape(Bsz, S, H, P), "dp", None, "model", None)
    if ssm_state is None:
        ssm_state = torch.zeros((Bsz, H, P, N), dtype=torch.float32,
                                device=h.device)
    y, ssm_state_new = _ssd_chunk_scan(x, dt, A, Bm, Cm, ssm_state,
                                       cfg.ssm_chunk)
    y = y + p["D"].to(torch.float32)[:, None] * x.to(torch.float32)
    y = y.reshape(Bsz, S, dd["d_inner"]).to(h.dtype)
    y = rmsnorm(y * Fn.silu(z), p["norm_w"], cfg.norm_eps)
    CAL.tap("ssm/out_proj", y)
    out = dense(y, p["out_proj"], impl=impl)
    return out, (conv_state_new, ssm_state_new)


def mamba2_decode(h, p: Dict, cfg, conv_state, ssm_state, *,
                  impl: str = "auto"):
    """Single-token decode. h: (B, d_model); conv_state: (B, W-1, C);
    ssm_state: (B, H, P, N). Returns (out (B, d), (conv_state,
    ssm_state)), new tensors."""
    dd = ssm_dims(cfg)
    Bsz = h.shape[0]
    H, P, N = dd["n_heads"], dd["head_dim"], dd["state"]

    zxbcdt = dense(h, p["in_proj"], impl=impl)
    z, xBC, dt = _split_proj(zxbcdt, cfg)
    # conv recurrence: append the new column, keep the last W
    hist = torch.cat([conv_state.to(xBC.dtype), xBC[:, None]], dim=1)
    conv_state_new = hist[:, 1:]
    xBC = _taps(hist, p["conv_w"], 1)[:, 0]
    xBC = Fn.silu(xBC + p["conv_b"].to(xBC.dtype))
    x, Bm, Cm = torch.split(xBC, [dd["d_inner"], N, N], dim=-1)
    dt = _softplus(dt.to(torch.float32) + p["dt_bias"].to(torch.float32))
    A = -torch.exp(p["A_log"].to(torch.float32))
    x = x.reshape(Bsz, H, P).to(torch.float32)
    dA = torch.exp(dt * A)                                  # (B, H)
    inp = (dt[:, :, None, None] * Bm.to(torch.float32)[:, None, None, :]
           * x[..., None])                                  # (B, H, P, N)
    ssm_state_new = ssm_state * dA[..., None, None] + inp
    y = torch.matmul(ssm_state_new,
                     Cm.to(torch.float32)[:, None, :, None])[..., 0]
    y = y + p["D"].to(torch.float32)[:, None] * x
    y = y.reshape(Bsz, dd["d_inner"]).to(h.dtype)
    y = rmsnorm(y * Fn.silu(z), p["norm_w"], cfg.norm_eps)
    out = dense(y, p["out_proj"], impl=impl)
    return out, (conv_state_new, ssm_state_new)


def naive_recurrence(x, dt, A, Bm, Cm, state0):
    """Step-by-step reference for tests. Same shapes as _ssd_chunk_scan."""
    f32 = torch.float32
    state = state0.to(f32)
    Af = A.to(f32)
    ys = []
    for t in range(x.shape[1]):
        xt, dtt = x[:, t].to(f32), dt[:, t].to(f32)
        Bt, Ct = Bm[:, t].to(f32), Cm[:, t].to(f32)
        dA = torch.exp(dtt * Af)
        state = state * dA[..., None, None] + (
            dtt[:, :, None, None] * Bt[:, None, None, :] * xt[..., None])
        ys.append(torch.einsum("bn,bhpn->bhp", Ct, state))
    return torch.stack(ys, dim=1), state
