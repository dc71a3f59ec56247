"""Build, load and launch-count the hand-written CUDA kernels.

Every ``csrc/*.cu`` source has a plain C interface (a ``<entry>_launch``
function per entry point, ``<name>_launch`` for the kernel's own, each
returning ``cudaGetLastError()``) and compiles on
its own with ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
-Xcompiler -fPIC`` into ``build/repro_torch_kernels/`` at the repository
root.  The build happens at first use, never at import: all sources start
compiling together (one ``nvcc`` each) and the libraries load through
``ctypes``.  Outputs are named by a hash of source and flags, so a rerun
in the same checkout reuses them and an edited source rebuilds.

``LAUNCHES`` counts, per kernel, the launches that the wrappers made:
each wrapper adds one right where it launches its kernel, and nowhere
else.  Plain-version calls (CPU tensors) never count.

Any thread may build, load or launch (the serving frontend's worker
launches beside the main thread): one module lock serializes the build,
the library and entry caches and the launch counts.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
# the kernels whose launches are counted, each with the ``csrc`` source
# (stem) that holds its entry; SOURCES are the files to build
KERNELS = {
    "rank_packed": "rank_packed", "rank_select": "rank_select",
    "radix_hist": "radix_hist", "radix_pos": "radix_pos",
    "rerank_scan": "rerank_scan", "char_histogram": "char_histogram",
    "fm_query_packed": "fm_query_packed",
    "fm_query_unpacked": "fm_query_unpacked", "merge_walk": "merge_walk",
    "fm_query_stacked_packed": "fm_query_stacked",
    "fm_query_stacked_unpacked": "fm_query_stacked",
}
SOURCES = tuple(dict.fromkeys(KERNELS.values()))
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
# argtypes of each C entry point (``<entry>_launch``): c_void_p for every
# pointer and the stream, c_longlong for 64-bit strides
SIGNATURES = {
    "rank_packed": [_P, _I, _I, _I, _P, _P, _P, _P, _I, _P],
    # blocks, r, blk, sym, cut, out, B, group, vec, grid, stream
    "rank_select": [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "radix_hist": [_P, _I, _I, _I, _P, _P],
    "radix_pos": [_P, _P, _I, _I, _I, _I, _I, _P, _I] + [_P] * 8 + [_P],
    "rerank_scan": [_P, _P, _I, _P, _P, _I, _P],
    "char_histogram": [_P, _I, _I, _P, _P],
    # layout, n, C, SA sample (marks, ranks, vals, n_vals, rate, val_bits),
    # patterns, B, m, k, sp, ep, positions, stream
    "fm_query_packed": [_P, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                        _I, _P, _I, _I, _I, _P, _P, _P, _P],
    "fm_query_unpacked": [_P, _P, _I, _I, _I, _I, _P, _P, _P, _P, _I, _I,
                          _I, _P, _I, _I, _I, _P, _P, _P, _P],
    # pairwise walk: left rows (fused, blocks, occ, wid, n_blocks), sigma,
    # bits, r, cA, cB, right (symbol, LF) pairs, nB, ends, seed rows, SA
    # rate, seed stride, seeds, meets, ins, stream
    "merge_walk": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P,
                   _I, _I, _I, _P, _P, _P],
    # k-way walk: stacked rows (fused, blocks, occ, wid, NB), sigma, bits,
    # r, c_mat, nb, row, last, len, k, walked (symbol, LF) pairs, seed
    # rows, SA rate, seed stride, seeds, meets, ins, stream
    "merge_walk_kway": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P,
                        _I, _P, _P, _I, _I, _I, _P, _P, _P],
    # stacked catalog: layout (fused, wid | blocks, occ), NB, sigma, (bits),
    # r, n_seg, seg_pad, n_blocks, lengths, C, SA sample (marks, ranks,
    # vals, MW, MV, rate), patterns, B, m, k, (the packed entry's tile),
    # sp, ep, positions, stream
    "fm_query_stacked_packed": [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P,
                                _P, _P, _P, _L, _L, _I, _P, _I, _I, _I, _I,
                                _P, _P, _P, _P],
    "fm_query_stacked_unpacked": [_P, _P, _I, _I, _I, _I, _I, _P, _P, _P,
                                  _P, _P, _P, _L, _L, _I, _P, _I, _I, _I,
                                  _P, _P, _P, _P],
}

LAUNCHES = {name: 0 for name in KERNELS}
BUILD_LOG: dict[str, str] = {}   # nvcc/ptxas output per source (last build)
_libs: dict[str, ctypes.CDLL] = {}
_entries: dict[str, object] = {}
# reentrant: library() builds under it, launch() loads under it
_LOCK = threading.RLock()


def reset_launches() -> None:
    with _LOCK:
        for name in LAUNCHES:
            LAUNCHES[name] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _target(name: str) -> Path:
    """The library of source ``name``, named by a hash of the source, every
    shared header (``csrc/*.cuh``) and the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.name.encode() + header.read_bytes()
    digest = hashlib.sha1(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> float:
    """Compile every kernel that has no up-to-date library; returns the
    wall seconds spent.  One ``nvcc`` per source, all started together;
    raises with the compiler's output if any of them fails."""
    with _LOCK:
        return _build_all()


def _build_all() -> float:
    t0 = time.perf_counter()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in SOURCES:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(
            f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"--- {name} (rc={proc.returncode})\n{log}")
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of source ``name`` (building first)."""
    with _LOCK:
        if name not in _libs:
            build_all()
            _libs[name] = ctypes.CDLL(str(_target(name)))
        return _libs[name]


def _entry(name: str, entry: str):
    with _LOCK:
        if entry not in _entries:
            fn = getattr(library(KERNELS[name]), f"{entry}_launch")
            fn.argtypes = SIGNATURES[entry]
            fn.restype = ctypes.c_int
            _entries[entry] = fn
        return _entries[entry]


def launch(name: str, *args, entry: str | None = None) -> None:
    """Call the C entry ``<entry>_launch`` (default: the kernel's own,
    ``name``) of kernel ``name``'s library on PyTorch's current stream,
    raise on a launch error, and count one launch of kernel ``name``."""
    fn = _entry(name, entry or name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"{entry or name} kernel launch failed: CUDA "
                           f"error {err}")
    with _LOCK:
        LAUNCHES[name] += 1


def query(name: str, symbol: str, argtypes, *args) -> int:
    """Call the C function ``symbol`` of kernel ``name``'s library, of
    ``argtypes``: a query such as an occupancy, which launches nothing and
    is not counted; returns its result."""
    with _LOCK:
        if symbol not in _entries:
            fn = getattr(library(KERNELS[name]), symbol)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            _entries[symbol] = fn
        fn = _entries[symbol]
    return fn(*args)


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Raise unless every tensor is a contiguous int32 CUDA tensor on one
    device (what every kernel here takes)."""
    for t in tensors:
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    dev = tensors[0].device
    if any(t.device != dev or t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{name}: tensors must share one CUDA device")


def on_cpu(*tensors: torch.Tensor) -> bool:
    """The dispatch rule of every wrapper: CPU tensors take the plain
    version; anything else launches the kernel (or raises in
    ``check_cuda``).  No switch or fallback reroutes a CUDA tensor."""
    return all(t.device.type == "cpu" for t in tensors)
