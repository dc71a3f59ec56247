"""Attention variants (GQA / sliding-window / MLA), MLPs, and MoE.

All functions are (params, x, ...) -> y with plain dict param trees, as in
the JAX package's ``models/blocks.py``, and come in two modes:
  * train/prefill: full sequence, causal (optionally windowed) mask
  * decode: one new token against a KV cache at position ``pos`` (an int);
    the cache is written in place, the counterpart of the reference's
    donated cache

Spec builders (``*_specs``) are the single source of truth for shapes and
logical sharding axes (models/common.ParamSpec).

In a world of ranks (``sharding.world_context``) the params and
activations are this rank's blocks by ``spec_for`` and the decode caches
by the reference's cache layout (``sharding.cache_spec``: attention's
sequence over ``model``), and each function runs on them as the
reference's GSPMD program does on a device: the dims over ``data`` /
``pod`` (ZeRO-3's fsdp, the lora ranks, the expert hidden dim) are
gathered before use, the heads / mlp / experts stay split over ``model``
and one ``psum`` over ``model`` sums the rank's share of the output
projection; a decode step scores each rank's positions and combines the
ranks' partial softmaxes.  The MoE follows the reference's ``shard_map``: routing
on the rank's own tokens, capacity from their count.  Attention is the
reference's own math (a materialised softmax, or the online softmax over
KV chunks), not a library attention, so the port computes what the
reference computes.  Logits and softmax statistics are float32 whatever
the activations' dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..sharding import (
    MeshContext,
    all_gather,
    axes_of,
    cache_spec,
    constrain,
    gather_spec,
    psum,
    require_one_device,
)
from .common import (
    ParamSpec,
    apply_rope,
    dense,
    einsum,
    gelu,
    rms_norm,
    tree_map,
)

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# a layer's weights in a world
# ---------------------------------------------------------------------------

def spec_of(ctx: MeshContext, spec: ParamSpec) -> tuple:
    return ctx.spec_for(spec.axes, spec.shape)


def gathered(p, ctx: MeshContext, make_specs, *args, keep=("model",)):
    """The layer's weights ``p`` (blocks by the specs ``make_specs(*args)``
    gives) with every dim whole but those over the axes in ``keep``; ``p``
    itself off a world, where no spec is built."""
    if ctx.world is None:
        return p
    specs = make_specs(*args)
    return tree_map(lambda t, s: gather_spec(t, ctx, spec_of(ctx, s), keep),
                    p, specs)


def model_block(ctx: MeshContext, entry, size: int) -> tuple[int, int]:
    """(first index, count) of this rank's block of a dim of ``size`` whose
    spec entry is ``entry``: a split over ``model`` or the whole dim."""
    if ctx.world is None or "model" not in axes_of(entry):
        return 0, size
    n = size // ctx.mesh["model"]
    return ctx.coordinate(("model",)) * n, n


def row_parallel(h, w, x, cfg: ArchConfig, ctx: MeshContext, split: bool):
    """``dense(h, w)`` over this rank's rows of ``w`` (its share of the
    input dim, ``split`` when that is not all of it), summed over model:
    the block's (B, S, d) output beside its input ``x``."""
    y = dense(h, w)
    if split:
        y = psum(y, ctx)
    return constrain(y, ctx, ("batch", None, None),
                     (ctx.batch_of(x), x.shape[1], cfg.d_model))


def local_batch(ctx: MeshContext, batch: int) -> int:
    """This rank's rows of a global ``batch`` (``batch`` off a world)."""
    if ctx.world is None:
        return batch
    return ctx.local_shape(ctx.spec_for(("batch",), (batch,)), (batch,))[0]


# ---------------------------------------------------------------------------
# GQA attention (covers MHA and MQA; optional sliding window)
# ---------------------------------------------------------------------------

def gqa_specs(cfg: ArchConfig) -> dict:
    d, H, Hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    specs = {
        "wq": ParamSpec((d, H, hd), ("fsdp", "heads", "head_dim")),
        "wk": ParamSpec((d, Hkv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, Hkv, hd), ("fsdp", "kv_heads", "head_dim")),
        "wo": ParamSpec((H, hd, d), ("heads", "head_dim", "fsdp")),
    }
    if cfg.qkv_bias:
        specs["bq"] = ParamSpec((H, hd), ("heads", "head_dim"), init="zeros")
        specs["bk"] = ParamSpec((Hkv, hd), ("kv_heads", "head_dim"), init="zeros")
        specs["bv"] = ParamSpec((Hkv, hd), ("kv_heads", "head_dim"), init="zeros")
    return specs


def _attend(q, k, v, mask):
    """q (B,S,H,hd), k/v (B,T,Hkv,hd), mask (B,1,S,T) or (1,1,S,T) bool.
    Materialises the full (S, T) logits — decode/small-S path and the
    oracle for the chunked version below."""
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    q = q.reshape(B, S, Hkv, group, hd)
    logits = einsum("bskgd,btkd->bkgst", q, k).float()
    logits = logits / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    logits = torch.where(mask[:, :, None] if mask.ndim == 4 else mask,
                         logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = einsum("bkgst,btkd->bskgd", probs, v)
    return out.reshape(B, S, H, hd)


def _causal_mask(S, T, offset: int = 0, window: int = 0, device=None):
    """(1, 1, S, T) bool; q position i (global offset+i) sees keys j <= i,
    and j > i - window when window > 0."""
    qpos = offset + torch.arange(S, device=device)[:, None]
    kpos = torch.arange(T, device=device)[None, :]
    m = kpos <= qpos
    if window > 0:
        m &= kpos > qpos - window
    return m[None, None]


ATTN_CHUNK = 1024  # KV-chunk length for the online-softmax path


def _attend_chunked(q, k, v, *, window: int = 0, chunk: int = ATTN_CHUNK):
    """Flash-style causal attention: a loop over KV chunks with an online
    softmax, so logits never exceed (B, Hkv, g, S, chunk) — the full
    (S, T) score matrix is never materialised.

    Self-attention layout: q (B,S,H,hd), k/v (B,S,Hkv,hd), same positions.
    """
    B, S, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    nc = S // chunk
    dev = q.device
    qr = q.reshape(B, S, Hkv, group, hd)
    scale = 1.0 / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    qpos = torch.arange(S, dtype=torch.int32, device=dev)

    m = torch.full((B, Hkv, group, S), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, Hkv, group, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, group, S, hd), dtype=torch.float32,
                      device=dev)
    for c0 in range(nc):
        kb = k[:, c0 * chunk:(c0 + 1) * chunk]
        vb = v[:, c0 * chunk:(c0 + 1) * chunk]
        kpos = c0 * chunk + torch.arange(chunk, dtype=torch.int32,
                                         device=dev)
        logits = einsum("bskgd,btkd->bkgst", qr, kb).float()
        logits = logits * scale
        mask = kpos[None, :] <= qpos[:, None]
        if window > 0:
            mask &= kpos[None, :] > qpos[:, None] - window
        logits = torch.where(mask[None, None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        # guard fully-masked rows (m_new == NEG_INF): keep weights at 0
        p = torch.exp(logits - m_new[..., None])
        p = torch.where(mask[None, None, None], p, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + einsum("bkgst,btkd->bkgsd", p,
                                             vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, hd).to(q.dtype)


def _gqa_qkv(p, x, cfg: ArchConfig, positions):
    q = einsum("bsd,dhk->bshk", x, p["wq"]).to(x.dtype)
    k = einsum("bsd,dhk->bshk", x, p["wk"]).to(x.dtype)
    v = einsum("bsd,dhk->bshk", x, p["wv"]).to(x.dtype)
    if cfg.qkv_bias:
        q = q + p["bq"].to(q.dtype)
        k = k + p["bk"].to(k.dtype)
        v = v + p["bv"].to(v.dtype)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _kv_index(cfg: ArchConfig, ctx: MeshContext):
    """The local kv head of each local q head, or None where the local kv
    heads group the local q heads as on one device: kv heads follow
    their own spec, so a q head's kv head may lie in another rank's block
    or be replicated (a single kv head)."""
    if ctx.world is None:
        return None
    specs = gqa_specs(cfg)
    q0, Hl = model_block(ctx, spec_of(ctx, specs["wq"])[1], cfg.num_heads)
    kv0, Hkvl = model_block(ctx, spec_of(ctx, specs["wk"])[1],
                            cfg.num_kv_heads)
    group = cfg.num_heads // cfg.num_kv_heads
    if Hkvl * group == Hl and q0 // group == kv0:
        return None
    return (q0 + torch.arange(Hl)) // group - kv0


def _attn_out(p, out, x, cfg: ArchConfig, ctx: MeshContext):
    """The output projection over the local heads, summed over model when
    the heads are split."""
    y = einsum("bshk,hkd->bsd", out, p["wo"]).to(x.dtype)
    if p["wo"].shape[0] < cfg.num_heads:
        y = psum(y, ctx)
    return constrain(y, ctx, ("batch", None, None),
                     (ctx.batch_of(x), x.shape[1], cfg.d_model))


def gqa_attention(p, x, cfg: ArchConfig, ctx: MeshContext, *, window: int = 0,
                  positions=None):
    """Full-sequence causal attention.  x (B, S, d)."""
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    p = gathered(p, ctx, gqa_specs, cfg)
    kv_idx = _kv_index(cfg, ctx)
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    q = constrain(q, ctx, ("batch", None, "act_model", None),
                  (ctx.batch_of(x), S, cfg.num_heads, cfg.head_dim))
    if kv_idx is not None:
        k, v = k[:, :, kv_idx.to(x.device)], v[:, :, kv_idx.to(x.device)]
    if S % ATTN_CHUNK == 0 and S > ATTN_CHUNK:
        out = _attend_chunked(q, k, v, window=window)
    else:
        out = _attend(q, k, v, _causal_mask(S, S, window=window,
                                            device=x.device))
    return _attn_out(p, out, x, cfg, ctx)


def gqa_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device=None, ctx: MeshContext | None = None):
    """Zeroed k / v (batch, max_len, kv heads, head_dim); in a world this
    rank's block by the reference's cache layout (``cache_leaf``)."""
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    return {name: cache_leaf(name, shape, dtype, device, ctx)
            for name in ("k", "v")}


def gqa_decode(p, x, cache, pos: int, cfg: ArchConfig, ctx: MeshContext, *,
               window: int = 0):
    """One-token decode.  x (B, 1, d); cache k/v (B, T, Hkv, hd), written in
    place at the new token's slot; pos — the index of the new token.
    Returns (y, cache).  In a world the cache is the rank's block of the
    reference's layout (``_gqa_decode_world``)."""
    require_one_device(ctx)
    B = x.shape[0]
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    p = gathered(p, ctx, gqa_specs, cfg)
    q, k, v = _gqa_qkv(p, x, cfg, positions)
    if ctx.world is not None:
        out = _gqa_decode_world(q, k, v, cache, pos, cfg, ctx, window)
        return _attn_out(p, out, x, cfg, ctx), cache
    # windowed caches store key at pos % T (ring buffer); full caches at pos
    # (caches may be low-precision, e.g. fp8 — cast on write, upcast on read)
    T = cache["k"].shape[1]
    cdt = cache["k"].dtype
    slot = pos % T if window > 0 else min(pos, T - 1)
    cache["k"][:, slot] = k[:, 0].to(cdt)
    cache["v"][:, slot] = v[:, 0].to(cdt)
    mask = _decode_mask(torch.arange(T, device=x.device), pos, slot, T,
                        window)
    out = _attend(q, cache["k"].to(x.dtype), cache["v"].to(x.dtype),
                  mask[None, None, None, :])
    return _attn_out(p, out, x, cfg, ctx), cache


def _decode_mask(kpos, pos: int, slot: int, T: int, window: int):
    """Which cache entries (global indices ``kpos`` of a cache of T) a
    token at ``pos`` sees, its key written at ``slot``."""
    if window > 0:
        # ring: entry j holds the absolute position below; valid if within
        # the last ``window`` positions <= pos
        abs_pos = torch.where(kpos <= slot, pos - slot + kpos,
                              pos - slot - T + kpos)
        return (abs_pos >= 0) & (abs_pos <= pos) & (abs_pos > pos - window)
    return kpos <= pos


# ---------------------------------------------------------------------------
# decode over a cache split by sequence (a world)
# ---------------------------------------------------------------------------
#
# The reference's layout splits the sequence of every attention cache leaf
# over ``model`` and keeps all kv heads (or the whole latent) in each
# block (``sharding.cache_spec``).  A rank scores every q head against its
# own positions and keeps the running max, sum and weighted values of its
# softmax share; one all_gather over model brings every rank's shares of
# its head block, which it combines.  No rank holds a whole sequence.

def cache_leaf(name: str, shape, dtype, device, ctx: MeshContext | None):
    """A zeroed cache leaf of global ``shape``: in a world this rank's
    block by ``sharding.cache_spec``."""
    if ctx is not None and ctx.world is not None:
        shape = ctx.local_shape(cache_spec(name, shape, ctx, shape[0]),
                                shape)
    return torch.zeros(shape, dtype=dtype, device=device)


def _cache_positions(ctx: MeshContext, name: str, local: tuple,
                     window: int = 0) -> tuple[int, int, int]:
    """(T, first, count): the global length of an attention cache leaf
    whose block on this rank has shape ``local`` (B, T_local, ...), and
    the block's first position and count.  T is the call's ``cache_len``
    (a ring's at most ``window``), or read off the block where only one
    layout gives it: a block that ``model`` divides is a split one."""
    M = ctx.mesh.get("model", 1)
    if ctx.cache_len is not None:
        T = min(window, ctx.cache_len) if window > 0 else ctx.cache_len
    elif local[1] % M == 0:
        T = local[1] * M
    else:
        raise ValueError(
            f"a cache block of {local[1]} positions over model = {M} is a "
            f"whole cache or one of {M}: pass decode_step its max_len")
    shape = (ctx.batch, T, *local[2:])
    blk = ctx.block(cache_spec(name, shape, ctx, ctx.batch), shape)[1]
    if blk.stop - blk.start != local[1]:
        raise ValueError(f"a cache block of {local[1]} positions where a "
                         f"cache of {T} gives {blk.stop - blk.start}")
    return T, blk.start, blk.stop - blk.start


def _write_slot(cache, new: dict, j: int, count: int) -> None:
    """Write each ``new[name]`` (B, 1, ...) at this rank's position ``j``
    of its ``cache[name]`` block of ``count`` positions, cast to the
    cache's dtype, where the block holds it.  Every rank runs the same
    ops (a rank that does not hold it selects its own entry back), so
    every rank counts the same step."""
    own = 0 <= j < count
    j = min(max(j, 0), count - 1)
    for name, t in new.items():
        c = cache[name]
        keep = torch.full((), own, dtype=torch.bool, device=c.device)
        c[:, j] = torch.where(keep, t[:, 0].to(c.dtype), c[:, j])


def _whole_heads(parts: list, ctx: MeshContext) -> list:
    """Each (B, 1, h, d) block of heads in ``parts`` (split over model)
    with its heads whole: one all_gather over model for all of them."""
    if not parts:
        return []
    widths = [t.shape[2] for t in parts]
    g = all_gather(torch.cat(parts, 2)[None], ctx, ("model",), 0)
    out = []
    for t in g.split(widths, 3):              # (M, B, 1, h, d) each
        M, B, _, h, d = t.shape
        out.append(t.permute(1, 2, 0, 3, 4).reshape(B, 1, M * h, d))
    return out


def _partials(logits, mask, values, contract: str):
    """This rank's share of a softmax over its positions: the running max
    ``m``, the sum ``l`` of exp(logit - m) and the weighted ``values``
    ``acc`` (by the einsum ``contract``), all float32.  A block with no
    valid key gives m = NEG_INF and l = acc = 0."""
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1)
    w = torch.where(mask, torch.exp(logits - m[..., None]), 0.0)
    return m, w.sum(dim=-1), einsum(contract, w, values.float())


def _combine(m, l, acc, ctx: MeshContext, first: int, count: int):
    """Heads ``first`` .. ``first + count`` of the softmax-weighted sums
    over every rank's positions, from each rank's partials over its own
    (m, l (B, H), acc (B, H, c)): one all_gather over model of the packed
    partials, combined in rank order the same way on every rank.
    Returns (B, count, c) float32."""
    packed = torch.cat([m[..., None], l[..., None], acc], dim=-1)
    parts = all_gather(packed[None], ctx, ("model",), 0)[
        :, :, first:first + count]
    m, l, acc = parts[..., 0], parts[..., 1], parts[..., 2:]
    w = torch.exp(m - m.amax(dim=0))          # an empty block weighs 0
    l = (w * l).sum(dim=0)
    acc = (w[..., None] * acc).sum(dim=0)
    return acc / torch.clamp(l, min=1e-30)[..., None]


def _gqa_decode_world(q, k, v, cache, pos: int, cfg: ArchConfig,
                      ctx: MeshContext, window: int):
    """The attention of one new token (q (B, 1, Hl, hd) of this rank's
    q heads, k / v of its kv heads) over the cache's rank's block: all
    kv heads of the rank's positions (the whole sequence where ``model``
    does not divide it).  The new token's kv heads gathered whole reach
    the rank that holds its slot; over a split sequence every q head is
    scored against the rank's positions and the partials combined for
    its own heads.  Returns the (B, 1, Hl, hd) output."""
    Bl, _, Hl, hd = q.shape
    H, Hkv = cfg.num_heads, cfg.num_kv_heads
    T, t0, Tl = _cache_positions(ctx, "k", tuple(cache["k"].shape), window)
    split = Tl < T
    q0, _ = model_block(ctx, spec_of(ctx, gqa_specs(cfg)["wq"])[1], H)
    need_q, split_kv = split and Hl < H, k.shape[2] < Hkv
    whole = _whole_heads([q] * need_q + [k, v] * split_kv, ctx)
    q_all = whole.pop(0) if need_q else q
    if split_kv:
        k, v = whole
    slot = pos % T if window > 0 else min(pos, T - 1)
    _write_slot(cache, {"k": k, "v": v}, slot - t0, Tl)
    kpos = t0 + torch.arange(Tl, device=q.device)
    mask = _decode_mask(kpos, pos, slot, T, window)
    ck, cv = cache["k"].to(q.dtype), cache["v"].to(q.dtype)
    if not split:
        if Hl < H:      # this rank's q heads against their kv heads
            idx = ((q0 + torch.arange(Hl)) // (H // Hkv)).to(q.device)
            ck, cv = ck[:, :, idx], cv[:, :, idx]
        return _attend(q, ck, cv, mask[None, None, None, :])
    qr = q_all.reshape(Bl, 1, Hkv, H // Hkv, hd)
    logits = einsum("bskgd,btkd->bkgst", qr, ck).float()
    logits = logits / torch.sqrt(torch.tensor(hd, dtype=torch.float32))
    m, l, acc = _partials(logits, mask, cv, "bkgst,btkd->bkgsd")
    out = _combine(m.reshape(Bl, H), l.reshape(Bl, H),
                   acc.reshape(Bl, H, hd), ctx, q0, Hl)
    return out[:, None].to(q.dtype)


# ---------------------------------------------------------------------------
# MLA — multi-head latent attention (DeepSeek-V2 / MiniCPM3)
# ---------------------------------------------------------------------------

def mla_specs(cfg: ArchConfig) -> dict:
    d, H = cfg.d_model, cfg.num_heads
    qn, qr, vd = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    ql, kl = cfg.q_lora_rank, cfg.kv_lora_rank
    specs = {
        "kv_down": ParamSpec((d, kl + qr), ("fsdp", "kv_lora")),
        "kv_norm": ParamSpec((kl,), ("kv_lora",), init="zeros"),
        "k_up": ParamSpec((kl, H, qn), ("kv_lora", "heads", "head_dim")),
        "v_up": ParamSpec((kl, H, vd), ("kv_lora", "heads", "head_dim")),
        "wo": ParamSpec((H, vd, d), ("heads", "head_dim", "fsdp")),
    }
    if ql > 0:
        specs["q_down"] = ParamSpec((d, ql), ("fsdp", "q_lora"))
        specs["q_norm"] = ParamSpec((ql,), ("q_lora",), init="zeros")
        specs["q_up"] = ParamSpec((ql, H, qn + qr), ("q_lora", "heads", "head_dim"))
    else:
        specs["q_proj"] = ParamSpec((d, H, qn + qr), ("fsdp", "heads", "head_dim"))
    return specs


def _mla_q(p, x, cfg: ArchConfig):
    if cfg.q_lora_rank > 0:
        cq = rms_norm(dense(x, p["q_down"]), p["q_norm"], cfg.norm_eps)
        q = einsum("bsq,qhk->bshk", cq, p["q_up"]).to(x.dtype)
    else:
        q = einsum("bsd,dhk->bshk", x, p["q_proj"]).to(x.dtype)
    return torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim], dim=-1)


def _mla_kv_latent(p, x, cfg: ArchConfig):
    ckv_full = dense(x, p["kv_down"])                     # (B,S,kl+qr)
    ckv, k_rope = torch.split(ckv_full, [cfg.kv_lora_rank, cfg.qk_rope_dim],
                              dim=-1)
    ckv = rms_norm(ckv, p["kv_norm"], cfg.norm_eps)
    return ckv, k_rope


def _mla_scale(cfg: ArchConfig):
    """The softmax scale as a 0-d float32 CPU tensor: it multiplies tensors
    on any device with no copy to theirs."""
    return 1.0 / torch.sqrt(torch.tensor(cfg.qk_nope_dim + cfg.qk_rope_dim,
                                         dtype=torch.float32))


def _mla_attend(p, q_nope, q_rope, ckv, k_rope, cfg: ArchConfig, mask):
    """q_* (B,S,H,*); ckv (B,T,kl); k_rope (B,T,qr) already roped."""
    k_nope = einsum("btc,chk->bthk", ckv, p["k_up"]).to(q_nope.dtype)
    v = einsum("btc,chk->bthk", ckv, p["v_up"]).to(q_nope.dtype)
    logits = (
        einsum("bshk,bthk->bhst", q_nope, k_nope)
        + einsum("bshk,btk->bhst", q_rope, k_rope)
    ).float() * _mla_scale(cfg)
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return einsum("bhst,bthk->bshk", probs, v)


def _mla_attend_chunked(p, q_nope, q_rope, ckv, k_rope, cfg: ArchConfig,
                        *, chunk: int = ATTN_CHUNK):
    """Flash-style MLA: expands each KV chunk from the latent on the fly —
    neither the (S, T) scores nor the full expanded K/V ever materialise."""
    B, S, H, _ = q_nope.shape
    nc = S // chunk
    dev = q_nope.device
    scale = _mla_scale(cfg)
    qpos = torch.arange(S, dtype=torch.int32, device=dev)
    hd_v = cfg.v_head_dim

    m = torch.full((B, H, S), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, H, S), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, H, S, hd_v), dtype=torch.float32, device=dev)
    for c0 in range(nc):
        ckv_b = ckv[:, c0 * chunk:(c0 + 1) * chunk]
        kr_b = k_rope[:, c0 * chunk:(c0 + 1) * chunk]
        k_nope_b = einsum("btc,chk->bthk", ckv_b, p["k_up"]).to(q_nope.dtype)
        v_b = einsum("btc,chk->bthk", ckv_b, p["v_up"]).to(q_nope.dtype)
        logits = (
            einsum("bshk,bthk->bhst", q_nope, k_nope_b)
            + einsum("bshk,btk->bhst", q_rope, kr_b)
        ).float() * scale
        kpos = c0 * chunk + torch.arange(chunk, dtype=torch.int32, device=dev)
        mask = kpos[None, :] <= qpos[:, None]
        logits = torch.where(mask[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1))
        pw = torch.exp(logits - m_new[..., None])
        pw = torch.where(mask[None, None], pw, 0.0)
        corr = torch.exp(m - m_new)
        l = l * corr + pw.sum(dim=-1)
        acc = acc * corr[..., None] + einsum("bhst,bthk->bhsk", pw,
                                             v_b.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.permute(0, 2, 1, 3).to(q_nope.dtype)  # (B,S,H,hd_v)


def mla_attention(p, x, cfg: ArchConfig, ctx: MeshContext, *, positions=None):
    B, S, _ = x.shape
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :]
    p = gathered(p, ctx, mla_specs, cfg)
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv, k_rope = _mla_kv_latent(p, x, cfg)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)
    if S % ATTN_CHUNK == 0 and S > ATTN_CHUNK:
        out = _mla_attend_chunked(p, q_nope, q_rope, ckv, k_rope, cfg)
    else:
        mask = _causal_mask(S, S, device=x.device)
        out = _mla_attend(p, q_nope, q_rope, ckv, k_rope, cfg, mask)
    return _attn_out(p, out, x, cfg, ctx)


def mla_init_cache(cfg: ArchConfig, batch: int, max_len: int, dtype,
                   device=None, ctx: MeshContext | None = None):
    """Zeroed latent cache; in a world this rank's block by the
    reference's cache layout (``cache_leaf``: its rows and positions, the
    latent whole)."""
    return {name: cache_leaf(name, (batch, max_len, width), dtype, device,
                             ctx)
            for name, width in (("ckv", cfg.kv_lora_rank),
                                ("k_rope", cfg.qk_rope_dim))}


def mla_decode(p, x, cache, pos: int, cfg: ArchConfig, ctx: MeshContext):
    require_one_device(ctx)
    B = x.shape[0]
    cdt = cache["ckv"].dtype
    pos = int(pos)
    positions = torch.full((B, 1), pos, dtype=torch.int32, device=x.device)
    p = gathered(p, ctx, mla_specs, cfg)
    q_nope, q_rope = _mla_q(p, x, cfg)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    ckv_new, k_rope_new = _mla_kv_latent(p, x, cfg)
    k_rope_new = apply_rope(k_rope_new, positions, cfg.rope_theta)
    if ctx.world is not None:
        out = _mla_decode_world(p, q_nope, q_rope, ckv_new, k_rope_new,
                                cache, pos, cfg, ctx)
        return _attn_out(p, out, x, cfg, ctx), cache
    T = cache["ckv"].shape[1]
    slot = min(pos, T - 1)
    cache["ckv"][:, slot] = ckv_new[:, 0].to(cdt)
    cache["k_rope"][:, slot] = k_rope_new[:, 0].to(cdt)
    mask = (torch.arange(T, device=x.device) <= pos)[None, None, None, :]
    out = _mla_attend(p, q_nope, q_rope, cache["ckv"].to(x.dtype),
                      cache["k_rope"].to(x.dtype), cfg, mask)
    return _attn_out(p, out, x, cfg, ctx), cache


def _mla_decode_world(p, q_nope, q_rope, ckv_new, k_rope_new, cache,
                      pos: int, cfg: ArchConfig, ctx: MeshContext):
    """MLA's decode over the rank's block of the latent cache (its
    positions; the whole sequence where ``model`` does not divide it).
    The new token's latent is whole on every rank; the rank that holds
    its slot writes it.  Over a split sequence the absorbed form: each of
    the rank's q heads' ``q_nope`` folded through ``k_up`` into the
    latent, the folded q heads gathered whole, every head scored against
    the rank's ckv / k_rope block, the latent-weighted partials combined
    for the rank's heads and taken through its ``v_up``.  Returns the
    (B, 1, Hl, v_head_dim) output."""
    dt = q_nope.dtype
    T, t0, Tl = _cache_positions(ctx, "ckv", tuple(cache["ckv"].shape))
    slot = min(pos, T - 1)
    _write_slot(cache, {"ckv": ckv_new, "k_rope": k_rope_new}, slot - t0,
                Tl)
    mask = t0 + torch.arange(Tl, device=q_nope.device) <= pos
    if Tl == T:
        return _mla_attend(p, q_nope, q_rope, cache["ckv"].to(dt),
                           cache["k_rope"].to(dt), cfg,
                           mask[None, None, None, :])
    # float32 from the fold on: the absorbed form's sums run over the
    # latent, where the expanded form's run over q / k heads
    Bl, _, Hl, _ = q_nope.shape
    H, kl = cfg.num_heads, cfg.kv_lora_rank
    q0, _ = model_block(ctx, spec_of(ctx, mla_specs(cfg)["k_up"])[1], H)
    q = torch.cat([einsum("bshk,chk->bshc", q_nope.float(),
                          p["k_up"].float()),
                   q_rope.float()], dim=-1)       # (B, 1, Hl, kl + qr)
    if Hl < H:
        q, = _whole_heads([q], ctx)
    q_lat, q_rope = torch.split(q, [kl, cfg.qk_rope_dim], dim=-1)
    ckv = cache["ckv"].float()
    logits = (einsum("bshc,btc->bhst", q_lat, ckv)
              + einsum("bshk,btk->bhst", q_rope, cache["k_rope"].float()))
    logits = logits * _mla_scale(cfg)
    m, l, acc = _partials(logits, mask, ckv, "bhst,btc->bhsc")
    lat = _combine(m[..., 0], l[..., 0], acc[:, :, 0], ctx, q0, Hl)
    out = einsum("bhc,chk->bhk", lat, p["v_up"].float()).to(dt)
    return out[:, None]


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def mlp_specs(cfg: ArchConfig, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = cfg.d_ff if d_ff is None else d_ff
    if cfg.mlp == "swiglu":
        return {
            "w_gate": ParamSpec((d, f), ("fsdp", "mlp")),
            "w_up": ParamSpec((d, f), ("fsdp", "mlp")),
            "w_down": ParamSpec((f, d), ("mlp", "fsdp")),
        }
    return {  # relu2 / gelu: single up-proj
        "w_up": ParamSpec((d, f), ("fsdp", "mlp")),
        "w_down": ParamSpec((f, d), ("mlp", "fsdp")),
    }


def mlp(p, x, cfg: ArchConfig, ctx: MeshContext, d_ff: int | None = None):
    """The FFN of hidden width ``d_ff`` (default ``cfg.d_ff``): column-
    parallel up, row-parallel down and a psum over model in a world."""
    f = cfg.d_ff if d_ff is None else d_ff
    p = gathered(p, ctx, mlp_specs, cfg, f)
    if cfg.mlp == "swiglu":
        h = F.silu(dense(x, p["w_gate"])) * dense(x, p["w_up"])
    elif cfg.mlp == "relu2":
        h = torch.square(F.relu(dense(x, p["w_up"])))
    else:
        h = gelu(dense(x, p["w_up"]))
    h = constrain(h, ctx, ("batch", None, "act_model"),
                  (ctx.batch_of(x), x.shape[1], f))
    return row_parallel(h, p["w_down"], x, cfg, ctx, h.shape[-1] < f)


# ---------------------------------------------------------------------------
# MoE: top-k routing, capacity drop
# ---------------------------------------------------------------------------
#
# The reference runs the routed part as a shard_map over (pod, data) token
# shards and 'model' expert shards, with a ZeRO-3 gather of the expert
# weights and one psum.  So does a world here; on one card every expert is
# local and the body runs with no gather and no psum.

def moe_specs(cfg: ArchConfig) -> dict:
    d, E, f = cfg.d_model, cfg.num_experts, cfg.moe_d_ff or cfg.d_ff
    specs = {
        "router": ParamSpec((d, E), ("fsdp", None)),
        "w_gate": ParamSpec((E, d, f), ("experts", "fsdp", "expert_ff")),
        "w_up": ParamSpec((E, d, f), ("experts", "fsdp", "expert_ff")),
        "w_down": ParamSpec((E, f, d), ("experts", "expert_ff", "fsdp")),
    }
    if cfg.num_shared_experts > 0:
        shared_f = f * cfg.num_shared_experts
        specs["shared"] = mlp_specs(cfg.replace(mlp="swiglu"), shared_f)
    return specs


def capacity(cfg: ArchConfig, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens (Python float math, as
    the reference)."""
    return max(1, int(cfg.capacity_factor * tokens * cfg.top_k
                      / cfg.num_experts))


def moe_route(xt, router, cfg: ArchConfig, first: int = 0,
              count: int | None = None):
    """Top-k routing and capacity dispatch of tokens xt (T, d) to experts
    ``first`` .. ``first + count`` (default all E).

    Returns (weights (T, k), experts (T, k), tok_idx (El, C), gate_w (El,
    C), valid (El, C)): expert first + e's slot c serves token tok_idx[e, c]
    with gate weight gate_w[e, c] where valid.  Ties break as ``jax.lax.top_k`` (the
    lower expert first: a stable descending sort) and the dispatch order is
    a stable argsort by expert, as ``jnp.argsort``."""
    E, k = cfg.num_experts, cfg.top_k
    Tl = xt.shape[0]
    dev = xt.device
    logits = einsum("td,de->te", xt, router).float()
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, experts = top.values[:, :k], top.indices[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)

    flat_expert = experts.reshape(Tl * k)
    flat_token = torch.arange(Tl, device=dev).repeat_interleave(k)
    flat_weight = weights.reshape(Tl * k)
    order = torch.argsort(flat_expert, stable=True)
    e_sorted = flat_expert[order].contiguous()
    t_sorted = flat_token[order]
    w_sorted = flat_weight[order]

    C = capacity(cfg, Tl)
    my_experts = first + torch.arange(E if count is None else count,
                                      device=dev)
    starts = torch.searchsorted(e_sorted, my_experts, side="left")
    ends = torch.searchsorted(e_sorted, my_experts, side="right")
    counts = ends - starts
    slots = torch.arange(C, device=dev)
    take = starts[:, None] + slots[None, :]                      # (E, C)
    valid = slots[None, :] < torch.clamp(counts, max=C)[:, None]
    take = torch.clamp(take, 0, Tl * k - 1)
    tok_idx = torch.where(valid, t_sorted[take], 0)
    gate_w = torch.where(valid, w_sorted[take], 0.0)
    return weights, experts, tok_idx, gate_w, valid


def _moe_local(xt, router, wg, wu, wd, *, cfg: ArchConfig, first: int = 0):
    """The routed experts ``first`` .. ``first + El`` on one rank.  xt
    (Tl, d) its tokens; wg/wu (El, d, f); wd (El, f, d)."""
    Tl, d = xt.shape
    E = wg.shape[0]
    _, _, tok_idx, gate_w, valid = moe_route(xt, router, cfg, first, E)
    C = tok_idx.shape[1]

    xe = xt[tok_idx]                                           # (E, C, d)
    h = F.silu(einsum("ecd,edf->ecf", xe, wg)) * einsum("ecd,edf->ecf", xe, wu)
    ye = einsum("ecf,efd->ecd", h.to(xt.dtype), wd)
    ye = ye * gate_w[..., None].to(ye.dtype)
    ye = torch.where(valid[..., None], ye, 0)
    # scatter-add of every slot into its token (index_add_: on CUDA the
    # order of the adds is not fixed, so sums move in the last bits)
    y = torch.zeros((Tl, d), dtype=xt.dtype, device=xt.device)
    return y.index_add_(0, tok_idx.reshape(-1), ye.reshape(E * C, d).to(y.dtype))


def _moe_world(p, x, cfg: ArchConfig, ctx: MeshContext):
    """The reference's shard_map in a world: the B*S tokens split over the
    batch axes (``ctx.batch_axes``, row-major), each rank routing its own;
    the expert weights gathered whole but their experts dim (over model);
    the rank's experts summed over model."""
    B, S, d = x.shape
    Bg = ctx.batch_of(x)
    baxes = ctx.batch_axes
    parts = ctx.axis_size(baxes)
    if (Bg * S) % parts:
        raise ValueError(
            f"{Bg * S} tokens over the batch axes {baxes} of {parts} ranks: "
            f"the reference's shard_map takes only a token dim they divide")
    Tl = Bg * S // parts
    r = ctx.coordinate(baxes)
    xaxes = axes_of(ctx.spec_for(("batch", None, None), (Bg, S, d))[0])
    same = xaxes == baxes
    if same:
        xt = x.reshape(Tl, d)
    else:   # rows laid out over fewer axes: cut the tokens from them all
        xt = all_gather(x, ctx, xaxes, 0).reshape(Bg * S, d)[
            r * Tl:(r + 1) * Tl]
    specs = moe_specs(cfg)
    routed = ("router", "w_gate", "w_up", "w_down")
    w = gathered({k: p[k] for k in routed}, ctx,
                 lambda: {k: specs[k] for k in routed})
    first, El = model_block(ctx, spec_of(ctx, specs["w_gate"])[0],
                            cfg.num_experts)
    y = _moe_local(xt, w["router"], w["w_gate"], w["w_up"], w["w_down"],
                   cfg=cfg, first=first)
    if El < cfg.num_experts:
        y = psum(y, ctx)
    if same:
        return y.reshape(B, S, d)
    y = all_gather(y, ctx, baxes, 0).reshape(Bg, S, d)
    return ctx.local_block(y, (xaxes or None, None, None))


def moe_block(p, x, cfg: ArchConfig, ctx: MeshContext):
    require_one_device(ctx)
    B, S, d = x.shape
    if ctx.world is None:
        y = _moe_local(x.reshape(B * S, d), p["router"], p["w_gate"],
                       p["w_up"], p["w_down"], cfg=cfg).reshape(B, S, d)
    else:
        y = _moe_world(p, x, cfg, ctx)
    y = constrain(y, ctx, ("batch", None, None), (ctx.batch_of(x), S, d))
    if cfg.num_shared_experts > 0:
        f = (cfg.moe_d_ff or cfg.d_ff) * cfg.num_shared_experts
        y = y + mlp(p["shared"], x, cfg.replace(mlp="swiglu"), ctx, f)
    return y
