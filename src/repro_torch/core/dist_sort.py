"""Distributed sorting / scanning primitives over a ``torch.distributed``
mesh, and the one place that knows the collectives' transport.

The JAX package runs these inside ``shard_map`` over the mesh axis
``"parts"``; here every rank is a process that calls them with its local
shard (SPMD: every rank makes the same calls in the same order).
``ShardInfo`` carries the mesh dimension's process group, and ``_me`` is
the rank in it.

Collectives (``all_gather``, ``gather``, ``ppermute``, ``all_to_all``,
``psum``, ``pmax``), counted per call in ``COLLECTIVES``, their input and
output bytes summed per kind in ``COLLECTIVE_BYTES`` (what
``launch/roofline.py`` ``collective_bytes`` turns into bytes moved):

* an NCCL group (one rank per card) takes CUDA tensors as they are;
* a gloo group takes CPU tensors as they are, and CUDA tensors (ranks that
  share one card) through pinned host copies: each collective copies its
  input to the host, runs there and copies the result back;
* a meta world's group (``launch/mesh.py`` ``meta_world``, torch's fake
  backend) takes ``meta`` tensors only and moves nothing: each call
  returns what the real one returns in shape and dtype (``gather`` its
  ``(P, ...)`` on rank 0, None elsewhere) and is recorded as a real
  call is; a tensor with storage raises, so no value is ever computed
  through collectives that move nothing.

``transport`` says which.  A failing collective raises; nothing falls back
to another route.

Engines, as in the reference: ``bitonic_sort_sharded`` (Batcher
merge-exchange, power-of-two parts, log^2 P ppermute rounds),
``samplesort_sharded`` (regular splitters and a capacity-bounded
``all_to_all``; overflow is reported, not hidden), the scatters that route
values back to index order, ``shift_sharded`` (two static ppermutes) and
the exclusive scans of per-shard aggregates.

Key operands are 32-bit words read as unsigned (the JAX package's uint32
key words, and its non-negative int32 keys) in int32 storage, sorted
through ``kernels.ops.local_sort``: the radix engine's CUDA kernels or the
stable compare sort.  Every sort operand is int32.

The LM's world (``sharding.py``) runs its collectives here too, over one
axis of its ``(pod, data, model)`` mesh at a time (``axis_info``): ``psum``
of float32 / bfloat16 activations (the dtype is kept on the wire: gloo
reduces bfloat16 itself), ``all_gather_tiled`` of weight, logit and token
blocks, and ``argmax_sharded``, the greedy pick over vocab blocks; its
training saves ``gather`` each leaf to rank 0 one axis at a time and
learn the write's outcome over ``world_info``.  The gradients through
these calls are ``sharding.py``'s (autograd Functions over them).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Sequence

import torch
import torch.distributed as dist

# the local-sort dispatch lives in kernels.ops, shared with the
# single-device builder
from ..kernels import ops as kernel_ops
from ..kernels import traffic
from ..kernels._bits import u32
from ..kernels.ops import COMPARE

AXIS = "parts"
# the backend of a meta world (``launch/mesh.py`` ``meta_world``): torch's
# fake process group, whose collectives return at once
META_BACKEND = "fake"
# collective calls made by this rank, by kind
COLLECTIVES = {"all_gather": 0, "gather": 0, "ppermute": 0, "all_to_all": 0,
               "psum": 0, "pmax": 0}
# [input bytes, output bytes] of this rank's collective calls, by kind
COLLECTIVE_BYTES = {name: [0, 0] for name in COLLECTIVES}


def reset_collectives() -> None:
    for name in COLLECTIVES:
        COLLECTIVES[name] = 0
        COLLECTIVE_BYTES[name] = [0, 0]


def _record(name: str, t_in: torch.Tensor, t_out: torch.Tensor | None):
    """One call of collective ``name``: its count and its bytes."""
    COLLECTIVES[name] += 1
    COLLECTIVE_BYTES[name][0] += t_in.nbytes
    COLLECTIVE_BYTES[name][1] += 0 if t_out is None else t_out.nbytes


def pad_value(dtype=torch.int32) -> int:
    """The pad key of an unsigned 32-bit key word in int32 storage: all
    ones (0xFFFFFFFF, the JAX package's uint32 ``pad_value``), -1 here."""
    if dtype != torch.int32:
        raise ValueError(f"key words are int32 storage, got {dtype}")
    return -1


def as_word(v: int) -> int:
    """An unsigned 32-bit value as the int32 bit pattern that stores it."""
    return v - (1 << 32) if v >= (1 << 31) else v


class ShardInfo(NamedTuple):
    """Static description of the sharded 1-D array layout."""

    axis: str        # mesh dimension the array is sharded over
    parts: int       # number of shards P (a power of two for bitonic)
    part_size: int   # local elements m; global n = P * m
    group: object    # the dimension's process group

    @property
    def n(self) -> int:
        return self.parts * self.part_size


def mesh_parts(mesh, axis: str = AXIS) -> int:
    """Size of the mesh dimension ``axis``."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise TypeError(f"a mesh is a DeviceMesh with a {axis!r} dimension "
                        f"(launch/mesh.py make_index_mesh), not "
                        f"{type(mesh).__name__}")
    if axis not in names:
        raise ValueError(f"mesh has no dimension {axis!r} (has {names})")
    return mesh.size(names.index(axis))


def shard_info(mesh, n: int, axis: str = AXIS) -> ShardInfo:
    """The layout of a length-``n`` array sharded over ``mesh[axis]``."""
    parts = mesh_parts(mesh, axis)
    if n % parts:
        raise ValueError(f"n={n} not divisible by axis size {parts}")
    return ShardInfo(axis, parts, n // parts, mesh.get_group(axis))


def _me(info: ShardInfo) -> int:
    return dist.get_rank(info.group)


def axis_info(mesh, axis: str) -> ShardInfo:
    """The process group of one dimension of ``mesh`` (any ``DeviceMesh``,
    e.g. the LM's ``(pod, data, model)``), for the collectives below."""
    return ShardInfo(axis, mesh_parts(mesh, axis), 1, mesh.get_group(axis))


def world_info(mesh) -> ShardInfo:
    """Every rank of ``mesh`` (a ``DeviceMesh`` over the whole initialised
    world, as ``launch/mesh.py`` ``make_lm_mesh`` builds it) as one group,
    world rank order, for a save's ``gather``."""
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}")
    return ShardInfo("world", mesh.size(), 1, dist.group.WORLD)


# ---------------------------------------------------------------------------
# the collectives (the only code that knows the transport)
# ---------------------------------------------------------------------------

def transport(info: ShardInfo, device) -> str:
    """How this group's collectives move tensors that live on ``device``."""
    backend = dist.get_backend(info.group)
    if backend == META_BACKEND:
        return "meta: shapes only, no data moves"
    if torch.device(device).type == "cuda" and backend == "gloo":
        return "gloo, host-staged (CUDA tensors copied through pinned " \
               "host buffers)"
    return f"{backend}, direct"


def _wire(info: ShardInfo, x: torch.Tensor) -> torch.Tensor:
    """``x`` as the group's backend takes it: contiguous, its dtype kept
    (int32 words, float32, bfloat16; bools widen to int32), on the host
    through a pinned buffer when gloo meets a CUDA tensor."""
    backend = dist.get_backend(info.group)
    if backend == META_BACKEND and x.device.type != "meta":
        raise ValueError(
            f"a meta world's collectives take meta tensors only, got one on "
            f"{x.device}: no data moves there, so no real value may pass")
    x = x.contiguous()
    if x.dtype == torch.bool:
        x = x.to(torch.int32)
    if x.device.type == "cuda" and backend == "gloo":
        h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        h.copy_(x)
        return h
    if x.device.type != "cuda" and backend == "nccl":
        raise ValueError("an NCCL group takes CUDA tensors only")
    return x


def _collective(info: ShardInfo, call, *tensors: torch.Tensor) -> None:
    """Run ``call`` (one collective over ``tensors``); while a counter
    records (``launch/roofline.py`` ``count``), return only once the
    group holds none of them.  gloo's worker thread drops its references
    to a finished collective's tensors just after the caller wakes: a
    buffer the caller lets go at once would otherwise be freed there, at
    a moment no run repeats (the storage peak a counted step reports would
    vary from run to run and rank to rank).  The wait is bounded: a group
    that keeps a reference longer only loses that determinism.  Outside
    a count nothing waits."""
    if not traffic.counting() or dist.get_backend(info.group) != "gloo":
        call()
        return
    before = [t._use_count() for t in tensors]
    call()
    deadline = time.monotonic() + 1.0
    while (any(t._use_count() > n for t, n in zip(tensors, before))
           and time.monotonic() < deadline):
        time.sleep(0)


def _back(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """A collective's result on ``like``'s device and dtype."""
    return y.to(device=like.device, dtype=like.dtype)


def all_gather(info: ShardInfo, x: torch.Tensor) -> torch.Tensor:
    """(P, *x.shape): every rank's ``x``, in rank order."""
    t = _wire(info, x)
    out = [torch.empty_like(t) for _ in range(info.parts)]
    _collective(info, lambda: dist.all_gather(out, t, group=info.group),
                t, *out)
    gathered = torch.stack(out)
    _record("all_gather", t, gathered)
    return _back(gathered, x)


def all_gather_tiled(info: ShardInfo, x: torch.Tensor, dim: int
                     ) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (the
    reference's ``lax.all_gather(..., tiled=True)``)."""
    return torch.cat(all_gather(info, x).unbind(0), dim=dim)


def argmax_sharded(info: ShardInfo, x: torch.Tensor, offset: int
                   ) -> torch.Tensor:
    """The global argmax over the last dim of ``x``, a block of it that
    starts at global index ``offset`` on this rank (blocks in rank order):
    the largest value, ties to the lower global index, as ``jnp.argmax``
    of the whole array picks."""
    val, idx = torch.max(x, dim=-1)          # the first of a local tie
    vals = all_gather(info, val)             # (P, ...)
    ids = all_gather(info, idx + offset)
    best = vals.amax(0)
    return torch.where(vals == best, ids, torch.iinfo(ids.dtype).max
                       ).amin(0)


def gather(info: ShardInfo, x: torch.Tensor) -> torch.Tensor | None:
    """(P, *x.shape) on rank 0: every rank's ``x``, in rank order; None on
    the other ranks, which only send (a save's gather: no rank but the
    writer holds the whole array)."""
    t = _wire(info, x)
    out = (torch.empty((info.parts, *t.shape), dtype=t.dtype,
                       device=t.device) if _me(info) == 0 else None)
    rows = [] if out is None else list(out.unbind(0))
    _collective(info, lambda: dist.gather(
        t, rows or None, dst=dist.get_global_rank(info.group, 0),
        group=info.group), t, *rows)
    _record("gather", t, out)
    return None if out is None else _back(out, x)


def ppermute(info: ShardInfo, x: torch.Tensor, perm) -> torch.Tensor:
    """Collective permutation: ``perm`` lists (source, destination) pairs
    covering every rank once; each rank gets its source's ``x``.  One
    ``all_to_all_single`` whose only non-empty split goes to this rank's
    destination."""
    me = _me(info)
    dst = {s: d for s, d in perm}
    src = {d: s for s, d in perm}
    if len(dst) != info.parts or len(src) != info.parts:
        raise ValueError(f"ppermute needs a permutation of {info.parts} "
                         f"ranks, got {perm}")
    t = _wire(info, x).reshape(-1)
    out = torch.empty_like(t)
    send = [0] * info.parts
    recv = [0] * info.parts
    send[dst[me]] = recv[src[me]] = t.numel()
    _collective(info, lambda: dist.all_to_all_single(
        out, t, recv, send, group=info.group), t, out)
    _record("ppermute", t, out)
    return _back(out.view(x.shape), x)


def all_to_all(info: ShardInfo, buf: torch.Tensor) -> torch.Tensor:
    """``buf`` (P, ...): block d goes to rank d; returns (P, ...) with
    block s from rank s (the reference's tiled ``lax.all_to_all``)."""
    t = _wire(info, buf)
    out = torch.empty_like(t)
    _collective(info, lambda: dist.all_to_all_single(
        out, t, group=info.group), t, out)
    _record("all_to_all", t, out)
    return _back(out, buf)


def _all_reduce(info: ShardInfo, x: torch.Tensor, op, name: str):
    t = _wire(info, x)
    if t is x:
        t = t.clone()
    _collective(info, lambda: dist.all_reduce(t, op=op, group=info.group),
                t)
    _record(name, t, t)
    return _back(t, x)


def psum(info: ShardInfo, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(info, x, dist.ReduceOp.SUM, "psum")


def pmax(info: ShardInfo, x: torch.Tensor) -> torch.Tensor:
    return _all_reduce(info, x, dist.ReduceOp.MAX, "pmax")


# ---------------------------------------------------------------------------
# distributed exclusive scans (per-shard aggregates)
# ---------------------------------------------------------------------------

def exclusive_scan_sharded(info: ShardInfo, local_agg: torch.Tensor
                           ) -> torch.Tensor:
    """Sum of ``local_agg`` over all ranks with a smaller index
    (``local_agg`` may be a scalar or carry trailing dims)."""
    gathered = all_gather(info, local_agg)
    return gathered[:_me(info)].sum(0, dtype=local_agg.dtype)


def exclusive_max_sharded(info: ShardInfo, local_agg: torch.Tensor,
                          identity: int = -1) -> torch.Tensor:
    """Max of ``local_agg`` over ranks with a smaller index (``identity``
    when there is none)."""
    gathered = all_gather(info, local_agg)
    floor = torch.full_like(local_agg, identity)[None]
    return torch.cat([gathered[:_me(info)], floor]).amax(0)


# ---------------------------------------------------------------------------
# distributed shift (the paper's "Shifting and Pairing" map)
# ---------------------------------------------------------------------------

def shift_sharded(info: ShardInfo, x: torch.Tensor, h: int, fill: int
                  ) -> torch.Tensor:
    """out[g] = x[g + h] for global g, ``fill`` past the end: the data of
    any destination shard lives on at most two source shards, so two
    static ppermutes."""
    P, m = info.parts, info.part_size
    q, rs = divmod(h, m)
    if q >= P:  # the whole shard is past the end
        return torch.full_like(x, fill)
    # I receive the shard of rank (me + q); sender i sends to (i - q)
    a = ppermute(info, x, [(i, (i - q) % P) for i in range(P)]) \
        if q % P != 0 else x
    if rs == 0:
        out = a
    else:
        b = ppermute(info, x, [(i, (i - q - 1) % P) for i in range(P)])
        out = torch.cat([a[rs:], b[:rs]])
    # local slots whose global index + h is still inside the text
    live = torch.arange(m, device=x.device) < info.n - h - _me(info) * m
    return torch.where(live, out, fill)


# ---------------------------------------------------------------------------
# engine 1: bitonic merge-exchange
# ---------------------------------------------------------------------------

def _merge_split(info: ShardInfo, operands: tuple, num_keys: int, j: int,
                 keep_low: bool, is_lower: bool, engine: str, key_bits):
    """Exchange full shards with partner ``me ^ j`` (all operands in one
    ppermute) and keep the low or high half of the merged 2m block.

    Both partners sort the SAME sequence, the lower rank's shard first:
    the local engines are stable, so with tied keys the payload order
    depends on concatenation order, and this makes the kept halves exactly
    complementary."""
    m = info.part_size
    mine = torch.stack(operands)
    theirs = ppermute(info, mine, [(i, i ^ j) for i in range(info.parts)])
    lo, hi = (mine, theirs) if is_lower else (theirs, mine)
    merged = kernel_ops.local_sort(
        tuple(torch.cat([a, b]) for a, b in zip(lo, hi)), num_keys,
        engine=engine, key_bits=key_bits)
    start = 0 if keep_low else m
    return tuple(x[start: start + m] for x in merged)


def bitonic_sort_sharded(info: ShardInfo, operands: Sequence[torch.Tensor],
                         num_keys: int = 1, *, local_sort: str = COMPARE,
                         key_bits=None) -> tuple[torch.Tensor, ...]:
    """Globally sort sharded arrays lexicographically by the first
    ``num_keys`` operands (unsigned words); the rest are payloads carried
    along.  Returns shards of the globally sorted sequence (rank d holds
    global positions [d*m, (d+1)*m)): deterministic sizes, no capacity
    bounds."""
    P = info.parts
    if P & (P - 1):
        raise ValueError(f"bitonic engine needs power-of-two parts, got {P}")
    operands = kernel_ops.local_sort(tuple(operands), num_keys,
                                     engine=local_sort, key_bits=key_bits)
    me = _me(info)
    k = 2
    while k <= P:
        j = k // 2
        while j >= 1:
            ascending = (me & k) == 0
            is_lower = me < (me ^ j)
            operands = _merge_split(info, operands, num_keys, j,
                                    is_lower == ascending, is_lower,
                                    local_sort, key_bits)
            j //= 2
        k *= 2
    return operands


def scatter_to_index_bitonic(info: ShardInfo, gidx: torch.Tensor,
                             values: tuple, *, local_sort: str = COMPARE
                             ) -> tuple[torch.Tensor, ...]:
    """Route (gidx, values) so rank d ends up with the values of global
    indices [d*m, (d+1)*m) in order.  ``gidx`` must be a permutation of
    0..n-1, so sorting by it is a deterministic all-to-all."""
    kb = (max(1, info.n - 1).bit_length(),)
    sorted_ops = bitonic_sort_sharded(info, (gidx, *values), num_keys=1,
                                      local_sort=local_sort, key_bits=kb)
    return sorted_ops[1:]


# ---------------------------------------------------------------------------
# engine 2: sample sort (paper-faithful range shuffle)
# ---------------------------------------------------------------------------

def _lex_less(a: tuple, b: tuple) -> torch.Tensor:
    """Elementwise lexicographic a < b over parallel key arrays (int64
    holding unsigned values)."""
    lt = torch.zeros(torch.broadcast_shapes(a[0].shape, b[0].shape),
                     dtype=torch.bool, device=a[0].device)
    eq = torch.ones_like(lt)
    for x, y in zip(a, b):
        lt = lt | (eq & (x < y))
        eq = eq & (x == y)
    return lt


def _lex_searchsorted(sorted_keys: tuple, queries: tuple) -> torch.Tensor:
    """searchsorted(side='left') for multi-key unsigned words: position of
    the first sorted element not less than each query.  One binary search
    over every query at once."""
    m = sorted_keys[0].shape[0]
    steps = max(1, (m - 1).bit_length())
    keys = tuple(u32(k) for k in sorted_keys)
    qs = tuple(u32(q) for q in queries)
    lo = torch.zeros(qs[0].shape, dtype=torch.int64, device=qs[0].device)
    hi = torch.full_like(lo, m)
    for _ in range(steps + 1):
        mid = (lo + hi) // 2
        key_mid = tuple(k[torch.clamp(mid, max=m - 1)] for k in keys)
        # frozen once converged: extra iterations must not move the bounds
        active = lo < hi
        go_right = _lex_less(key_mid, qs)
        lo = torch.where(active & go_right, mid + 1, lo)
        hi = torch.where(active & ~go_right, mid, hi)
    return lo.to(torch.int32)


class SampleSortResult(NamedTuple):
    operands: tuple        # local slots, valid entries sorted first
    n_valid: torch.Tensor  # int32 scalar: valid slots on this rank
    overflow: torch.Tensor  # bool scalar: capacity exceeded on any rank


def _capacity(info: ShardInfo, capacity_factor: float) -> int:
    """Slots per (source, destination) bucket: ceil(factor * m / P)."""
    return max(1, int(-(-capacity_factor * info.part_size // info.parts)))


def samplesort_sharded(info: ShardInfo, operands: Sequence[torch.Tensor],
                       num_keys: int = 1, capacity_factor: float = 2.0, *,
                       key_pads: Sequence[int] | None = None,
                       n_valid_in: torch.Tensor | None = None,
                       local_sort: str = COMPARE,
                       key_bits=None) -> SampleSortResult:
    """The paper's range-partitioned sort: sample splitters, range-shuffle
    through one capacity-bounded all_to_all, sort locally.

    The global order is all valid elements of rank 0, then rank 1, ...
    (within a rank, valid slots sorted first, pad slots after).  Capacity
    per (src, dst) bucket is ``ceil(capacity_factor * m / P)``; overflow
    sets the flag (the caller retries with a larger factor).

    ``key_pads`` is the per-key pad as an unsigned value (default all
    ones).  A real key may equal its pad (saturated q-gram fields), so the
    recombine sort breaks ties on a validity key.  ``n_valid_in`` (this
    rank's count; the caller has set its trailing slots to the pads)
    restricts sampling to valid slots and keeps pad slots out of the
    shuffle entirely."""
    P, m = info.parts, info.part_size
    operands = tuple(operands)
    dev = operands[0].device
    pads = tuple(as_word(p) for p in key_pads) if key_pads is not None \
        else (pad_value(),) * num_keys

    # 1. local sort (stable engines; the caller's pad slots go last)
    ops = kernel_ops.local_sort(operands, num_keys, engine=local_sort,
                                key_bits=key_bits)
    keys_s = ops[:num_keys]
    m_valid = (torch.tensor(m, dtype=torch.int64, device=dev)
               if n_valid_in is None else n_valid_in.to(torch.int64))

    # 2. regular sampling over the valid prefix: P-1 local samples,
    # gathered, sorted; P-1 global splitters at regular positions
    sample_pos = torch.arange(1, P, device=dev) * m_valid // P
    samples = torch.stack([k[sample_pos] for k in keys_s])   # (K, P-1)
    gathered = all_gather(info, samples).transpose(0, 1).reshape(
        num_keys, P * (P - 1))
    gsorted = kernel_ops.local_sort(tuple(gathered), num_keys,
                                    engine=COMPARE)
    spl_pos = torch.arange(1, P, device=dev) * (P * (P - 1)) // P
    splitters = tuple(g[spl_pos] for g in gsorted)

    # 3. bucket boundaries in the local sorted run; pad slots sit past
    # m_valid and are never sent
    bounds = torch.minimum(_lex_searchsorted(keys_s, splitters).long(),
                           m_valid)
    starts = torch.cat([bounds.new_zeros(1), bounds])
    ends = torch.cat([bounds, m_valid[None]])
    counts = ends - starts                                  # (P,) per dst
    cap = _capacity(info, capacity_factor)
    overflow = (counts > cap).any()

    # 4. padded send blocks (P, cap) of every operand plus the validity
    # plane, shuffled in one all_to_all (written in place, and every
    # temporary freed before the next full-size one: at a full shard these
    # are the build's largest arrays)
    slot = torch.arange(cap, device=dev)
    valid_send = slot[None, :] < torch.clamp(counts, max=cap)[:, None]
    take = torch.clamp(starts[:, None] + slot[None, :], 0, m - 1)
    del slot
    send = torch.empty((P, len(ops) + 1, cap), dtype=torch.int32,
                       device=dev)
    for i, x in enumerate(ops):
        send[:, i] = x[take]
        send[:, i].masked_fill_(~valid_send, pads[i] if i < num_keys else 0)
    send[:, -1] = valid_send
    K = len(ops)
    del take, valid_send, ops, keys_s
    recv = all_to_all(info, send)                          # (P, K+1, cap)
    del send
    flat = recv.transpose(0, 1).reshape(K + 1, P * cap)
    del recv

    # 5. local sort of the received slots; invalid slots forced to the pad
    # on every key and ordered after the valid ones by the validity key
    vmask = flat[-1].bool()
    flat = tuple(torch.where(vmask, x, pads[i]) if i < num_keys
                 else x.clone() for i, x in enumerate(flat[:-1]))
    inv = (~vmask).to(torch.int32)
    n_valid = vmask.sum(dtype=torch.int32)
    del vmask
    tb_bits = None if key_bits is None else (*tuple(key_bits), 1)
    final = kernel_ops.local_sort(
        (*flat[:num_keys], inv, *flat[num_keys:]), num_keys + 1,
        engine=local_sort, key_bits=tb_bits)
    del flat, inv
    final = (*final[:num_keys], *final[num_keys + 1:])
    return SampleSortResult(final, n_valid, pmax(info, overflow).bool())


def scatter_to_index_samplesort(info: ShardInfo, gidx: torch.Tensor,
                                values: tuple, valid: torch.Tensor,
                                capacity_factor: float = 2.0):
    """Route (gidx, *values) to the owner shard of each global index
    (owner = gidx // m) through one capacity-bounded all_to_all.  Returns
    (index-ordered local values, overflow flag); invalid slots are
    dropped."""
    P, m = info.parts, info.part_size
    slots = gidx.shape[0]
    dev = gidx.device
    cap = _capacity(info, capacity_factor)
    dest = torch.where(valid, gidx // m, P)  # P == "nowhere"

    # stable bucket slot: position among same-destination elements (each
    # temporary freed as soon as the next is made: at a full shard these
    # are the build's largest arrays)
    order = torch.sort(dest, stable=True).indices
    dest_s = dest[order]
    del dest
    slot_s = torch.arange(slots, device=dev) - torch.searchsorted(dest_s,
                                                                  dest_s)
    live = dest_s < P
    overflow = (live & (slot_s >= cap)).any()

    # send blocks (P, K, cap) of gidx and the values, -1 where unused; row
    # P takes whatever does not fit and is cut off
    ok = live & (slot_s < cap)
    del live
    row = torch.where(ok, dest_s, P)
    del ok, dest_s
    col = torch.clamp(slot_s, 0, cap - 1)
    del slot_s
    planes = (gidx, *values)
    send = torch.full((P + 1, len(planes), cap), -1, dtype=torch.int32,
                      device=dev)
    for i, x in enumerate(planes):
        send[row, i, col] = x[order]
    del row, col, order
    recv = all_to_all(info, send[:P])                      # (P, K, cap)
    del send
    recv = recv.transpose(0, 1).reshape(len(planes), P * cap)
    local = torch.where(recv[0] >= 0, recv[0] % m, m).long()
    outs = []
    for v in recv[1:]:
        out = torch.zeros(m + 1, dtype=torch.int32, device=dev)
        out[local] = v   # slot m takes the unused slots and is cut off
        outs.append(out[:m])
    return tuple(outs), pmax(info, overflow).bool()
