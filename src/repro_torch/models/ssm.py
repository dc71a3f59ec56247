"""State-space blocks: Mamba2 SSD (state-space duality) and RG-LRU (Griffin),
as in the JAX package's ``models/ssm.py``.

Both are sub-quadratic: the full-sequence forms use chunked / linear
recurrences; decode keeps an O(1) recurrent state, written in place.  The
SSM and LRU states are float32 whatever the activations' dtype.

The reference's ``lax.associative_scan`` over the recurrence
h_t = a_t * h_{t-1} + x_t is ``linear_recurrence`` here: a log-depth
(Hillis-Steele) scan computing the same recurrence, with its own rounding.

In a world of ranks (``sharding.world_context``) both blocks split their
channels over ``model`` where the specs do: Mamba-2 by heads (its packed
``in_proj`` / conv columns gathered and cut per component, its gated norm
summing squares over model), RG-LRU by its width (the gate products, whose
input dim is split, summed over model).  The decode states are the rank's
rows and channels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding import MeshContext, psum, require_one_device
from .blocks import (
    gathered,
    local_batch,
    model_block,
    row_parallel,
    spec_of,
)
from .common import (
    ParamSpec,
    causal_conv1d,
    dense,
    einsum,
    gelu,
    rms_norm,
)


def linear_recurrence(a, x, dim: int):
    """h along ``dim`` with h_0 = x_0, h_t = a_t * h_{t-1} + x_t; ``a``
    broadcasts against ``x`` (trailing dims of size 1 allowed)."""
    n = x.shape[dim]
    h, a = x, a.expand_as(x)
    shift = 1
    while shift < n:
        h_prev = h.narrow(dim, 0, n - shift)
        a_prev = a.narrow(dim, 0, n - shift)
        h_tail = h.narrow(dim, shift, n - shift)
        a_tail = a.narrow(dim, shift, n - shift)
        h = torch.cat([h.narrow(dim, 0, shift), h_tail + a_tail * h_prev],
                      dim=dim)
        a = torch.cat([a.narrow(dim, 0, shift), a_tail * a_prev], dim=dim)
        shift *= 2
    return h


# ---------------------------------------------------------------------------
# Mamba2 SSD (arXiv:2405.21060, ssd_minimal_discrete)
# ---------------------------------------------------------------------------

def mamba2_specs(cfg: ArchConfig) -> dict:
    d, di, n, g = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    nh = di // cfg.ssm_headdim
    conv_ch = di + 2 * g * n
    return {
        # in_proj packs [z (gate), x, B, C, dt]
        "in_proj": ParamSpec(
            (d, 2 * di + 2 * g * n + nh), ("fsdp", "inner")
        ),
        "conv_w": ParamSpec((cfg.conv_width, conv_ch), ("conv", "inner")),
        "conv_b": ParamSpec((conv_ch,), ("inner",), init="zeros"),
        "A_log": ParamSpec((nh,), ("heads",), init="ones"),
        "D": ParamSpec((nh,), ("heads",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("heads",), init="zeros"),
        "norm": ParamSpec((di,), ("inner",), init="zeros"),
        "out_proj": ParamSpec((di, d), ("inner", "fsdp")),
    }


def _segsum(x):
    """Stable segment-sum: out[..., i, j] = sum_{k=j+1..i} x[..., k], -inf j>i."""
    L = x.shape[-1]
    x = x[..., None].expand(*x.shape, L)                      # (..., i, j)
    ones = torch.ones((L, L), dtype=torch.bool, device=x.device)
    x = torch.where(torch.tril(ones, diagonal=-1), x, 0)
    x_segsum = torch.cumsum(x, dim=-2)
    return torch.where(torch.tril(ones, diagonal=0), x_segsum, -torch.inf)


def ssd_chunked(x, dt, A, B, C, chunk: int, initial_state=None):
    """SSD over chunks.  x (b, s, h, p); dt (b, s, h); A (h,) negative;
    B, C (b, s, g, n).  Returns (y (b,s,h,p), final_state (b,h,p,n))."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g

    def to_chunks(t):
        return t.reshape(b, nc, chunk, *t.shape[2:])

    xc, dtc = to_chunks(x), to_chunks(dt)
    Bc = torch.repeat_interleave(to_chunks(B), rep, dim=3)    # (b,c,l,h,n)
    Cc = torch.repeat_interleave(to_chunks(C), rep, dim=3)

    dA = dtc * A[None, None, None, :]                         # (b,c,l,h) <= 0
    dA_cs = torch.cumsum(dA, dim=2)                           # within-chunk

    # 1. intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))            # (b,c,h,l,l)
    # every contraction is written pairwise: a path chosen for the fewest
    # operations materialises (b,c,h,l,s,n)-sized intermediates here
    att = einsum("bclhn,bcshn->bchls", Cc, Bc) * L
    y_diag = einsum("bchls,bcshp->bclhp",
                    att * dtc.permute(0, 1, 3, 2)[:, :, :, None, :], xc)

    # 2. chunk states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)     # (b,c,l,h)
    states = einsum("bclhn,bclhp->bchpn",
                    Bc * (decay_states * dtc)[..., None], xc)

    # 3. inter-chunk recurrence over c
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])               # (b,c,h)
    if initial_state is not None:
        states = torch.cat([initial_state[:, None], states], dim=1)
        chunk_decay = torch.cat(
            [torch.ones((b, 1, h), dtype=chunk_decay.dtype,
                        device=chunk_decay.device), chunk_decay], dim=1)
        st_sc = linear_recurrence(chunk_decay[..., None, None], states, 1)
        prev_states = st_sc[:, :-1]                           # state BEFORE chunk c
    else:
        st_sc = linear_recurrence(chunk_decay[..., None, None], states, 1)
        prev_states = torch.cat(
            [torch.zeros_like(st_sc[:, :1]), st_sc[:, :-1]], dim=1)
    final_state = st_sc[:, -1]

    # 4. inter-chunk output
    state_decay_out = torch.exp(dA_cs)                        # (b,c,l,h)
    y_off = einsum("bclhn,bchpn->bclhp", Cc,
                   prev_states) * state_decay_out[..., None]

    y = (y_diag + y_off).reshape(b, s, h, p)
    return y, final_state


class _Mamba2Local:
    """A rank's share of a Mamba-2 block: its heads [h0, h0 + nh) of the
    config's, their channels (di of them), each local head's B / C group,
    and the weights cut to them (``split``: heads over model)."""

    def __init__(self, p, cfg: ArchConfig, ctx: MeshContext):
        di, gn, hd = cfg.d_inner, cfg.ssm_groups * cfg.ssm_state, \
            cfg.ssm_headdim
        nh = di // hd
        self.h0, self.nh, self.di, self.split = 0, nh, di, False
        self.groups, self.p = None, p
        if ctx.world is None:
            return
        specs = mamba2_specs(cfg)
        self.h0, self.nh = model_block(ctx, spec_of(ctx, specs["A_log"])[0],
                                       nh)
        self.di = self.nh * hd
        self.split = self.nh < nh
        if not self.split:
            self.p = gathered(p, ctx, lambda: specs, keep=())
            return
        # the packed columns' blocks straddle components: gather them whole
        # and keep this rank's z / x / dt columns, and B and C whole
        packed = ("in_proj", "conv_w", "conv_b")
        w = gathered({k: v for k, v in p.items() if k not in packed}, ctx,
                     lambda: {k: v for k, v in specs.items()
                              if k not in packed})
        whole = gathered({k: p[k] for k in packed}, ctx,
                         lambda: {k: specs[k] for k in packed}, keep=())
        c0 = self.h0 * hd
        own = torch.arange(c0, c0 + self.di)
        bc = torch.arange(di, di + 2 * gn)
        heads = torch.arange(self.h0, self.h0 + self.nh)
        cols = torch.cat([own, di + own, di + bc, 2 * di + 2 * gn + heads])
        conv = torch.cat([own, bc]).to(p["conv_b"].device)
        w["in_proj"] = whole["in_proj"][:, cols.to(p["in_proj"].device)]
        w["conv_w"] = whole["conv_w"][:, conv]
        w["conv_b"] = whole["conv_b"][conv]
        self.p = w
        self.groups = heads // (nh // cfg.ssm_groups)

    def per_head(self, t, g: int, n: int):
        """B or C (..., g * n) as (..., g, n), or per local head when the
        heads are split."""
        t = t.reshape(*t.shape[:-1], g, n)
        return t if self.groups is None else t[..., self.groups.to(t.device),
                                                :]

    def gated_norm(self, y, weight, cfg: ArchConfig, ctx: MeshContext):
        """rms_norm over the whole d_inner: the sum of squares over model
        when the channels are split."""
        if not self.split:
            return rms_norm(y, weight, cfg.norm_eps)
        dt = y.dtype
        y = y.float()
        ss = psum(torch.sum(y * y, dim=-1, keepdim=True), ctx)
        y = y * torch.rsqrt(ss / cfg.d_inner + cfg.norm_eps)
        return (y * (1.0 + weight.float())).to(dt)


def _mamba2_project(p, x, cfg: ArchConfig, di: int, nh: int):
    gn = cfg.ssm_groups * cfg.ssm_state
    zxbcdt = dense(x, p["in_proj"])
    z, xin, Bf, Cf, dt = torch.split(zxbcdt, [di, di, gn, gn, nh], dim=-1)
    # jax.nn.softplus has no threshold; torch's (20) changes nothing in
    # float32, where log1p(exp(-20)) is below half an ulp of 20
    dt = F.softplus(dt + p["dt_bias"].to(dt.dtype))
    return z, xin, Bf, Cf, dt


def _mamba2_conv(p, z_x_b_c, cfg: ArchConfig, di: int, state=None):
    xin, Bf, Cf = z_x_b_c
    gn = cfg.ssm_groups * cfg.ssm_state
    conv_in = torch.cat([xin, Bf, Cf], dim=-1)
    conv_out, conv_state = causal_conv1d(conv_in, p["conv_w"], state)
    conv_out = F.silu(conv_out + p["conv_b"].to(conv_out.dtype))
    return torch.split(conv_out, [di, gn, gn], dim=-1), conv_state


def mamba2_block(p, x, cfg: ArchConfig, ctx: MeshContext):
    """Full-sequence Mamba2 block.  x (B, S, d)."""
    Bsz, S, _ = x.shape
    n, g = cfg.ssm_state, cfg.ssm_groups
    hd = cfg.ssm_headdim
    lay = _Mamba2Local(p, cfg, ctx)
    p, di, nh = lay.p, lay.di, lay.nh
    z, xin, Bf, Cf, dt = _mamba2_project(p, x, cfg, di, nh)
    (xin, Bf, Cf), _ = _mamba2_conv(p, (xin, Bf, Cf), cfg, di)

    A = -torch.exp(p["A_log"].float())                        # (nh,)
    xh = xin.reshape(Bsz, S, nh, hd)
    Bh = lay.per_head(Bf, g, n)
    Ch = lay.per_head(Cf, g, n)
    y, _ = ssd_chunked(xh.float(), dt.float(), A, Bh.float(), Ch.float(),
                       cfg.ssd_chunk)
    y = y + xh.float() * p["D"].float()[None, None, :, None]
    y = y.reshape(Bsz, S, di).to(x.dtype)
    y = lay.gated_norm(y * F.silu(z), p["norm"], cfg, ctx)
    return row_parallel(y, p["out_proj"], x, cfg, ctx, lay.split)


def mamba2_init_cache(cfg: ArchConfig, batch: int, dtype, device=None,
                      ctx: MeshContext | None = None):
    """Zeroed conv window and SSM state; in a world this rank's rows, heads
    and conv channels (its x channels, B and C whole)."""
    di, n, g = cfg.d_inner, cfg.ssm_state, cfg.ssm_groups
    nh = di // cfg.ssm_headdim
    if ctx is not None:
        batch = local_batch(ctx, batch)
        nh = model_block(ctx, spec_of(ctx, mamba2_specs(cfg)["A_log"])[0],
                         nh)[1]
        di = nh * cfg.ssm_headdim
    conv_ch = di + 2 * g * n
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, nh, cfg.ssm_headdim, n),
                           dtype=torch.float32, device=device),
    }


def mamba2_decode(p, x, cache, pos, cfg: ArchConfig, ctx: MeshContext):
    """One-token recurrent step.  x (B, 1, d); the cache's conv window and
    SSM state are overwritten in place."""
    require_one_device(ctx)
    Bsz = x.shape[0]
    n, g = cfg.ssm_state, cfg.ssm_groups
    hd = cfg.ssm_headdim
    lay = _Mamba2Local(p, cfg, ctx)
    p, di, nh = lay.p, lay.di, lay.nh
    z, xin, Bf, Cf, dt = _mamba2_project(p, x, cfg, di, nh)
    (xin, Bf, Cf), conv_state = _mamba2_conv(p, (xin, Bf, Cf), cfg, di,
                                             cache["conv"])

    A = -torch.exp(p["A_log"].float())
    xh = xin.reshape(Bsz, nh, hd).float()
    if lay.split:
        Bh = lay.per_head(Bf.reshape(Bsz, g * n), g, n).float()
        Ch = lay.per_head(Cf.reshape(Bsz, g * n), g, n).float()
    else:
        Bh = torch.repeat_interleave(Bf.reshape(Bsz, g, n), nh // g,
                                     dim=1).float()
        Ch = torch.repeat_interleave(Cf.reshape(Bsz, g, n), nh // g,
                                     dim=1).float()
    dts = dt.reshape(Bsz, nh).float()

    decay = torch.exp(dts * A[None, :])                       # (B, nh)
    h_new = (
        cache["ssm"] * decay[:, :, None, None]
        + einsum("bhn,bhp->bhpn", dts[:, :, None] * Bh, xh)
    )
    y = einsum("bhn,bhpn->bhp", Ch, h_new)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(Bsz, 1, di).to(x.dtype)
    y = lay.gated_norm(y * F.silu(z), p["norm"], cfg, ctx)
    out = row_parallel(y, p["out_proj"], x, cfg, ctx, lay.split)
    cache["conv"].copy_(conv_state)
    cache["ssm"].copy_(h_new)
    return out, cache


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma, arXiv:2402.19427)
# ---------------------------------------------------------------------------

RG_LRU_C = 8.0


def rglru_specs(cfg: ArchConfig) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    return {
        "in_x": ParamSpec((d, w), ("fsdp", "inner")),
        "in_gate": ParamSpec((d, w), ("fsdp", "inner")),
        "conv_w": ParamSpec((cfg.conv_width, w), ("conv", "inner")),
        "conv_b": ParamSpec((w,), ("inner",), init="zeros"),
        "lambda_p": ParamSpec((w,), ("inner",), init="ones", scale=1.0),
        "w_a": ParamSpec((w, w), ("inner", None), init="small"),
        "b_a": ParamSpec((w,), ("inner",), init="zeros"),
        "w_i": ParamSpec((w, w), ("inner", None), init="small"),
        "b_i": ParamSpec((w,), ("inner",), init="zeros"),
        "out": ParamSpec((w, d), ("inner", "fsdp")),
    }


def _rglru_local(p, cfg: ArchConfig, ctx: MeshContext):
    """(weights with the fsdp dims whole, the product over the whole width
    for the w_a / w_i gates, first local channel or None): the width split
    over model makes those gates' input dim split, so their partial
    products are summed over model and cut to the local channels."""
    if ctx.world is None:
        return p, dense, None
    specs = rglru_specs(cfg)
    w = cfg.lru_width or cfg.d_model
    c0, wl = model_block(ctx, spec_of(ctx, specs["in_x"])[1], w)
    p = gathered(p, ctx, lambda: specs)
    if wl == w:
        return p, dense, None

    def gate_product(x, wt):
        return psum(dense(x, wt), ctx)[..., c0:c0 + wl]

    return p, gate_product, c0


def _rglru_gates(p, xw, product=dense):
    """a_t = exp(log a_t) (log a_t <= 0) and the gated input, float32;
    xw (..., w)."""
    r = torch.sigmoid(product(xw, p["w_a"]) + p["b_a"].to(xw.dtype))
    i = torch.sigmoid(product(xw, p["w_i"]) + p["b_i"].to(xw.dtype))
    log_a = -RG_LRU_C * F.softplus(p["lambda_p"].float()) * r.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    gated = mult * i.float() * xw.float()
    return a, gated


def rglru_block(p, x, cfg: ArchConfig, ctx: MeshContext):
    """Full-sequence Griffin recurrent block.  x (B, S, d)."""
    p, product, c0 = _rglru_local(p, cfg, ctx)
    gate = gelu(dense(x, p["in_gate"]))
    xw = dense(x, p["in_x"])
    xw, _ = causal_conv1d(xw, p["conv_w"])
    xw = xw + p["conv_b"].to(xw.dtype)
    a, gated = _rglru_gates(p, xw, product)
    h = linear_recurrence(a, gated, 1)
    y = h.to(x.dtype) * gate
    return row_parallel(y, p["out"], x, cfg, ctx, c0 is not None)


def rglru_init_cache(cfg: ArchConfig, batch: int, dtype, device=None,
                     ctx: MeshContext | None = None):
    """Zeroed conv window and LRU state; in a world this rank's rows and
    channels."""
    w = cfg.lru_width or cfg.d_model
    if ctx is not None:
        batch = local_batch(ctx, batch)
        w = model_block(ctx, spec_of(ctx, rglru_specs(cfg)["in_x"])[1], w)[1]
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, w), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, 1, w), dtype=torch.float32, device=device),
    }


def rglru_decode(p, x, cache, pos, cfg: ArchConfig, ctx: MeshContext):
    require_one_device(ctx)
    p, product, c0 = _rglru_local(p, cfg, ctx)
    gate = gelu(dense(x, p["in_gate"]))
    xw = dense(x, p["in_x"])
    xw, conv_state = causal_conv1d(xw, p["conv_w"], cache["conv"])
    xw = xw + p["conv_b"].to(xw.dtype)
    a, gated = _rglru_gates(p, xw, product)
    h = a * cache["h"] + gated
    y = h.to(x.dtype) * gate
    out = row_parallel(y, p["out"], x, cfg, ctx, c0 is not None)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    return out, cache
