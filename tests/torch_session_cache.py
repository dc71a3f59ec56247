"""Helpers shared by the port's test files (``tests/test_torch_*.py``):

- ``cached(name, key, compute)``: ``compute()`` once per test session,
  shared by the xdist workers: the first worker to ask computes it under a
  file lock and pickles it under the session's temporary directory, every
  other worker (and every later call) reads it back.  ``key`` holds
  everything the result depends on, so a changed input misses the cache;
  the cache lives no longer than the session's temporary directory, so no
  result of one version of the code reaches another session.
- ``array_key(x)``: a content key of an array (dtype, shape and a hash of
  its bytes), for keys over a reference's inputs.
- ``one_thread``: a module-scoped autouse fixture that runs a module's
  tests on one intra-op thread (the suite's workers share the host's
  cores; torch's thread pool then only adds synchronisation).  A module
  takes it with ``from torch_session_cache import one_thread``.
- ``jax_compile_cache``: a module-scoped autouse fixture that turns on
  XLA's persistent compilation cache for the module's tests, in one
  directory the session's workers share, so that a program another
  worker already compiled (the JAX side of the parity tests builds the
  same small indexes in many files) is read back instead of compiled
  again.  A module takes it with ``from torch_session_cache import
  jax_compile_cache``.
- ``jax_reference_env(tmp_path_factory)``: the environment of a JAX
  reference run as a script (``--jax-reference``): the caller's, without
  its ``XLA_FLAGS`` (the script forces its own host devices), with the
  same shared compilation cache.
- ``load_chip_smoke()``: chip_smoke.py (repo root) as the module
  ``chip_smoke``, loaded once per process, so that the functions a test
  hands to spawned ranks are the ones the ranks import by that name.
"""

from __future__ import annotations

import hashlib
import importlib.util
import os
import pickle
import sys
from pathlib import Path

import numpy as np
import pytest
from filelock import FileLock

_ROOT: list[Path] = []   # the session's cache directory, set at first use


def session_root(basetemp: Path) -> Path:
    """The directory the session's workers share: the parent of the
    worker's base temporary directory under xdist (every worker's
    ``popen-gwN`` sits in one session directory), else the base temporary
    directory itself."""
    root = basetemp.parent if os.environ.get("PYTEST_XDIST_WORKER") \
        else basetemp
    return root / "torch_session_cache"


@pytest.fixture(autouse=True, scope="session")
def session_cache_root(tmp_path_factory):
    """Point ``cached`` at this session's shared directory (a module that
    calls ``cached`` imports this fixture)."""
    _ROOT[:] = [session_root(tmp_path_factory.getbasetemp())]
    yield


def array_key(x) -> tuple:
    """(dtype, shape, sha1 of the bytes) of an array-like, or None."""
    if x is None:
        return None
    a = np.ascontiguousarray(np.asarray(x))
    return (a.dtype.str, a.shape, hashlib.sha1(a.tobytes()).hexdigest())


def cached(name: str, key, compute):
    """``compute()``'s result for ``key``, computed once per session."""
    if not _ROOT:
        raise RuntimeError("cached() outside a session: import the "
                           "session_cache_root fixture into the module")
    root = _ROOT[0]
    root.mkdir(parents=True, exist_ok=True)
    digest = hashlib.sha1(pickle.dumps((name, key))).hexdigest()
    path = root / f"{name}-{digest}.pkl"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = compute()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, path)
        return value


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for the module's tests (restored after)."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load_chip_smoke():
    """The ``chip_smoke`` module, loaded from the repo root at first use."""
    if "chip_smoke" not in sys.modules:
        root = Path(__file__).resolve().parents[1]
        spec = importlib.util.spec_from_file_location("chip_smoke",
                                                      root / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        if str(root) not in sys.path:
            sys.path.append(str(root))
        try:
            spec.loader.exec_module(mod)
        except BaseException:
            del sys.modules["chip_smoke"]
            raise
    return sys.modules["chip_smoke"]


_JAX_CACHE_FLAGS = ("jax_compilation_cache_dir",
                    "jax_persistent_cache_min_compile_time_secs",
                    "jax_persistent_cache_min_entry_size_bytes")


def _jax_cache_dir(tmp_path_factory) -> Path:
    return session_root(tmp_path_factory.getbasetemp()).parent \
        / "jax_compile_cache"


def jax_reference_env(tmp_path_factory) -> dict:
    """os.environ without XLA_FLAGS, with the session's shared XLA
    compilation cache (every program cached) for a JAX reference script."""
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env.update(JAX_COMPILATION_CACHE_DIR=str(_jax_cache_dir(tmp_path_factory)),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0",
               JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES="-1")
    return env


@pytest.fixture(autouse=True, scope="module")
def jax_compile_cache(tmp_path_factory):
    """XLA's persistent compilation cache for the module's tests, under
    the session's shared temporary directory, every program cached (no
    minimum compile time or size).  Its key is the program (its HLO), the
    compile options, the backend, the XLA flags and the jax version, so a
    hit is the program the compiler would build and any change to a
    program misses.  The earlier settings come back after the module, so
    the JAX package's own test modules run as they would alone."""
    import jax
    from jax._src import compilation_cache

    path = _jax_cache_dir(tmp_path_factory)
    saved = {name: getattr(jax.config, name) for name in _JAX_CACHE_FLAGS}
    for name, value in zip(_JAX_CACHE_FLAGS, (str(path), 0.0, -1)):
        jax.config.update(name, value)
    compilation_cache.reset_cache()
    yield
    for name, value in saved.items():
        jax.config.update(name, value)
    compilation_cache.reset_cache()
