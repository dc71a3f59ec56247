"""Roofline terms of one NVIDIA H100 from counted operations and bytes.

Three terms per cell, in seconds, as the JAX package's
``launch/roofline.py`` defines them (its TPU constants and its HLO
parsing have no meaning on this card):

    compute    = matmul FLOPs / PEAK_FLOPS[dtype of the matmuls]
    memory     = bytes accessed / HBM_BW
    collective = collective bytes / NVLINK_BW

The counts come from running the step itself under one dispatch mode
(``count``): a step on ``meta`` tensors allocates nothing and is the
port's counterpart of the reference's lower + compile, a step on the card
is measured beside them.  Collective bytes apply the reference's per-op
byte model to the record ``core/dist_sort.py`` keeps of its own
collectives (``COLLECTIVE_BYTES``), not to HLO text.
"""

from __future__ import annotations

import dataclasses
import gc
import time
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..kernels import traffic

# published peaks of one H100 SXM (NVIDIA's data sheet: dense rates, no
# sparsity, at the full 700 W power limit)
PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12,
              "float32": 67e12}
HBM_BW = 3.35e12             # bytes/s, HBM3
NVLINK_BW = 450e9            # bytes/s per direction (NVLink 4, 900 GB/s
                             # both directions together)
# torch.cuda.get_device_properties(0).total_memory, read on an NVIDIA H100
# 80GB HBM3 at a 700.00 W power limit (chip_smoke.py phase 13 checks it)
HBM_BYTES = 85_017_493_504

# the reference's HLO collective kinds
_COLLECTIVES = (
    "all-gather", "all-reduce", "reduce-scatter", "all-to-all",
    "collective-permute",
)
# the port's collectives (core/dist_sort.py) by HLO kind; ``gather`` (a
# save's gather to rank 0) has no HLO counterpart in the reference's model
PORT_KINDS = {"all_gather": "all-gather", "psum": "all-reduce",
              "pmax": "all-reduce", "all_to_all": "all-to-all",
              "ppermute": "collective-permute", "gather": "gather"}


@dataclasses.dataclass
class CollectiveStats:
    counts: dict
    bytes_by_op: dict

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


def collective_bytes(records) -> CollectiveStats:
    """Per-device bytes moved by collectives, from ``records`` of (port
    kind, calls, input bytes, output bytes) (``dist_records``).

    Byte model (per device), the reference's:
      all-gather      : output - input      (receives everyone else's shard)
      reduce-scatter  : input - output      (sends everything but its shard)
      all-reduce      : 2 * (input)         (ring: reduce-scatter+all-gather)
      all-to-all      : input               (sends its full buffer)
      collective-permute : input            (one send)
    and for ``gather``: the root receives output - input, another rank
    sends its input.  Every term is linear in the calls, so a record may
    sum many calls of one kind.
    """
    counts: dict[str, int] = {}
    by_op: dict[str, int] = {}
    for kind, calls, in_b, out_b in records:
        if not calls:
            continue
        hlo = PORT_KINDS.get(kind, kind)
        if hlo == "all-gather":
            moved = max(out_b - in_b, 0) if in_b else out_b
        elif hlo == "reduce-scatter":
            moved = max(in_b - out_b, 0) if in_b else out_b
        elif hlo == "all-reduce":
            moved = 2 * (in_b or out_b)
        elif hlo == "gather":
            moved = max(out_b - in_b, 0) if out_b else in_b
        elif hlo in _COLLECTIVES:   # all-to-all, collective-permute
            moved = in_b or out_b
        else:
            raise ValueError(f"unknown collective kind {kind!r}")
        counts[hlo] = counts.get(hlo, 0) + calls
        by_op[hlo] = by_op.get(hlo, 0) + moved
    return CollectiveStats(counts, by_op)


def dist_records() -> list:
    """This rank's collectives since ``dist_sort.reset_collectives``, as
    ``collective_bytes`` records (one per kind)."""
    from ..core import dist_sort

    return [(kind, calls, *dist_sort.COLLECTIVE_BYTES[kind])
            for kind, calls in dist_sort.COLLECTIVES.items()]


@dataclasses.dataclass
class Roofline:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_detail: dict
    chips: int
    dtype: str = "bf16"       # whose peak the compute term uses

    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS[self.dtype]

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def step_time_s(self) -> float:
        """Perfect-overlap model: max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def to_dict(self) -> dict:
        return {
            "flops_per_device": self.flops_per_device,
            "bytes_per_device": self.bytes_per_device,
            "collective_bytes_per_device": self.collective_bytes_per_device,
            "collective_detail": self.collective_detail,
            "chips": self.chips,
            "dtype": self.dtype,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
            "step_time_s": self.step_time_s,
        }


def model_flops(cfg, tokens: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE): the useful-compute
    yardstick for the counted FLOPs."""
    from ..models.transformer import count_active_params

    return 6.0 * count_active_params(cfg) * tokens


# --------------------------------------------------------------------------
# counting a step under one dispatch mode
# --------------------------------------------------------------------------

@dataclasses.dataclass
class Counts:
    """What one run of a function did: matmul FLOPs (by the dtype of the
    matmuls), bytes accessed (aten ops outside the kernel wrappers plus
    the bytes the wrappers report), the high-water mark of the storage it
    created, its aten ops and its seconds."""

    flops_by_dtype: dict = dataclasses.field(default_factory=dict)
    aten_bytes: int = 0                 # ops outside any kernel wrapper
    kernel_bytes: dict = dataclasses.field(default_factory=dict)
    in_scope_bytes: dict = dataclasses.field(default_factory=dict)
    peak_bytes: int = 0
    ops: int = 0
    seconds: float = 0.0

    @property
    def flops(self) -> int:
        return sum(self.flops_by_dtype.values())

    @property
    def bytes(self) -> int:
        return self.aten_bytes + sum(self.kernel_bytes.values())

    @property
    def dtype(self) -> str:
        """The dtype that holds the most matmul FLOPs (bf16 when none)."""
        if not self.flops_by_dtype:
            return "bf16"
        return max(self.flops_by_dtype, key=self.flops_by_dtype.get)

    def scaled(self, k: int) -> "Counts":
        """``k`` runs of the same ops (the peak is one run's)."""
        def times(d):
            return {n: v * k for n, v in d.items()}
        return Counts(times(self.flops_by_dtype), self.aten_bytes * k,
                      times(self.kernel_bytes), times(self.in_scope_bytes),
                      self.peak_bytes, self.ops * k, self.seconds * k)

    def __add__(self, other: "Counts") -> "Counts":
        """Two runs one after the other (the larger peak)."""
        def plus(a, b):
            return {n: a.get(n, 0) + b.get(n, 0) for n in {*a, *b}}
        return Counts(plus(self.flops_by_dtype, other.flops_by_dtype),
                      self.aten_bytes + other.aten_bytes,
                      plus(self.kernel_bytes, other.kernel_bytes),
                      plus(self.in_scope_bytes, other.in_scope_bytes),
                      max(self.peak_bytes, other.peak_bytes),
                      self.ops + other.ops, self.seconds + other.seconds)

    def to_dict(self) -> dict:
        return {"flops": self.flops, "flops_by_dtype": self.flops_by_dtype,
                "bytes": self.bytes, "aten_bytes": self.aten_bytes,
                "kernel_bytes": self.kernel_bytes,
                "in_scope_bytes": self.in_scope_bytes,
                "peak_bytes": self.peak_bytes, "ops": self.ops,
                "seconds": self.seconds}


# factories whose output is allocated, not written
_ALLOCATIONS = {torch.ops.aten.empty.memory_format,
                torch.ops.aten.empty_strided.default,
                torch.ops.aten.empty_like.default,
                torch.ops.aten.new_empty.default,
                torch.ops.aten.new_empty_strided.default}
# in-place ops that write their ``self`` without reading it
_WRITE_ONLY = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_"}
# gathers read only the elements they select from their source (args[0])
_GATHERS = {"index", "_unsafe_index", "gather", "index_select", "embedding",
            "take"}
# in-place indexed writes touch only the elements they select in ``self``
# (reading them too where they accumulate)
_SCATTERS = {"index_put_", "_index_put_impl_", "scatter_", "scatter_add_",
             "scatter_reduce_", "index_add_", "index_copy_", "index_fill_"}
_ACCUMULATE = {"scatter_add_", "scatter_reduce_", "index_add_"}
_DTYPE_NAMES = {torch.bfloat16: "bf16", torch.float16: "fp16"}


def tensor_bytes(t: torch.Tensor) -> int:
    """Bytes of the distinct elements a tensor view spans: a broadcast
    (stride 0) dimension counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if size == 0:
            return 0
        if stride != 0:
            n *= size
    return n * t.element_size()


def _scattered(name: str, args) -> int:
    """Elements an in-place indexed write of ``name`` updates in
    ``args[0]``."""
    self_t = args[0]
    if name in ("index_put_", "_index_put_impl_"):
        values = args[2]
        if values.numel() > 1:
            return values.numel()
        idx = [i for i in args[1] if i is not None]
        n = 1
        for size in torch.broadcast_shapes(*(i.shape for i in idx)):
            n *= size
        for size in self_t.shape[len(args[1]):]:
            n *= size
        return n
    if name in ("index_add_", "index_copy_"):
        return args[3].numel()
    if name == "index_fill_":
        return args[2].numel() * (self_t.numel() // max(1, self_t.shape[
            args[1]]))
    return args[2].numel()        # scatter_*: one element per index


def _op_bytes(func, args, kwargs, ins, outs) -> int:
    """The bytes one aten op moves: each tensor input read once (a
    gather's source only as far as it selects), each output written once
    (an indexed write only where it writes); an output that is only
    written (``out=``, ``copy_``, ``fill_``...) is not read."""
    name = func._overloadpacket.__name__
    written = {id(t) for a in func._schema.arguments
               if a.kwarg_only and a.alias_info is not None
               and a.alias_info.is_write
               for t in _tensors(kwargs.get(a.name))}
    if name in _WRITE_ONLY and args:
        written.add(id(args[0]))
    out_bytes = sum(tensor_bytes(t) for t in outs)
    charge = {}
    if name in _GATHERS:
        charge[id(args[0])] = min(tensor_bytes(args[0]), out_bytes)
    elif name in _SCATTERS:
        accumulate = name in _ACCUMULATE or (
            name in ("index_put_", "_index_put_impl_") and len(args) > 3
            and bool(args[3]))
        out_bytes = min(out_bytes, _scattered(name, args)
                        * args[0].element_size())
        charge[id(args[0])] = out_bytes if accumulate else 0
    seen, nbytes = set(), out_bytes
    for t in ins:
        if id(t) not in seen and id(t) not in written:
            seen.add(id(t))
            nbytes += charge.get(id(t), tensor_bytes(t))
    return nbytes


def _tensors(x):
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for v in x:
            yield from _tensors(v)


def _matmul_dtype(dtype) -> str:
    if dtype == torch.float32:
        return ("float32" if torch.get_float32_matmul_precision() == "highest"
                else "tf32")
    return _DTYPE_NAMES.get(dtype, str(dtype).replace("torch.", ""))


class _CountMode(TorchDispatchMode):
    """The dispatch mode behind ``count``."""

    def __init__(self, counts: Counts):
        super().__init__()
        self.c = counts
        self.live = 0
        self.tracked: dict[int, weakref.ref] = {}

    def kernel_bytes(self, name: str, nbytes: int) -> None:
        self.c.kernel_bytes[name] = self.c.kernel_bytes.get(name, 0) + nbytes

    def _track(self, st) -> None:
        key = id(st)
        nbytes = st.nbytes()
        self.live += nbytes
        self.c.peak_bytes = max(self.c.peak_bytes, self.live)

        def freed(_ref, key=key, nbytes=nbytes):
            self.live -= nbytes
            self.tracked.pop(key, None)

        self.tracked[key] = weakref.ref(st, freed)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        scope = traffic.current_scope()
        if scope is traffic.RECKONING or func.namespace == "c10d":
            # a process group's own ops (a collective's send and receive)
            # belong to the collective term, from dist_sort's record
            return out
        c = self.c
        c.ops += 1
        ins = [t for a in (*args, *kwargs.values()) for t in _tensors(a)]
        outs = list(_tensors(out))
        in_storages = {id(t.untyped_storage()) for t in ins}
        fresh = []
        for t in outs:
            st = t.untyped_storage()
            if id(st) not in in_storages and id(st) not in self.tracked:
                fresh.append(st)
        for st in {id(s): s for s in fresh}.values():
            self._track(st)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            name = _matmul_dtype(outs[0].dtype)
            c.flops_by_dtype[name] = (c.flops_by_dtype.get(name, 0)
                                      + int(formula(*args, **kwargs,
                                                    out_val=out)))
        if not outs or func in _ALLOCATIONS:
            return out
        schema = func._schema
        if not schema.is_mutable and not fresh:
            return out           # a view or a metadata op
        nbytes = _op_bytes(func, args, kwargs, ins, outs)
        if scope is None:
            c.aten_bytes += nbytes
        else:
            c.in_scope_bytes[scope] = c.in_scope_bytes.get(scope, 0) + nbytes
        return out


def count(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` under one dispatch mode; returns
    ``(result, Counts)``:

    * matmul FLOPs by ``torch.utils.flop_counter``'s formulas, under the
      dtype of each product (float32 as "float32" at the "highest" matmul
      precision, else "tf32");
    * bytes accessed: each aten op's tensor inputs and outputs (a broadcast
      dimension once; an output that is only written is not read), with
      views, metadata ops and bare allocations counting 0; plus what each
      kernel wrapper reports (``kernels/traffic.py``), whose own aten ops
      are kept apart in ``in_scope_bytes``;
    * the high-water mark of live storage created inside ``fn``, per
      storage (views of it count once), freed when its last tensor dies;
      the cyclic garbage collector is off for the run, so that a storage
      is freed where its last reference goes, not wherever a collection
      happens to fall (two runs of one step, or one step on two ranks,
      give one peak).

    A process group's ops (``c10d``: the transfers of a collective) are
    left out: what a collective moves is the collective term's
    (``collective_bytes`` of ``dist_records``).

    On ``meta`` tensors nothing is allocated and nothing computed."""
    c = Counts()
    t0 = time.perf_counter()
    mode = _CountMode(c)
    collecting = gc.isenabled()
    gc.disable()
    try:
        with traffic.recording(mode), mode:
            out = fn(*args, **kwargs)
    finally:
        if collecting:
            gc.enable()
    c.seconds = time.perf_counter() - t0
    return out, c
