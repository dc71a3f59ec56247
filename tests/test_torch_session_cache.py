"""The test suite's session caches (``tests/torch_session_cache.py``):
``cached``, which shares the JAX side of the merge tests between
``test_torch_bwt_merge.py`` and ``test_torch_merge_chains.py`` (a result
is computed once per key, a changed input misses the cache, and what the
cache returns equals what the uncached path computes), and the shared
XLA compilation cache of ``jax_compile_cache`` (the same program at the
same shapes is read back, another shape or program is compiled).
"""

import dataclasses
from pathlib import Path

import numpy as np
import torch
import test_torch_bwt_merge as tbm
from torch_session_cache import array_key, cached
from torch_session_cache import jax_compile_cache  # noqa: F401 (fixture)
from torch_session_cache import session_cache_root  # noqa: F401 (fixture)


def test_a_key_is_computed_once_and_a_changed_key_again():
    calls = []

    def compute(v):
        calls.append(v)
        return {"value": v}

    key = ("inputs", np.arange(4).tobytes(), 3)
    assert cached("cache_probe", key, lambda: compute(1)) == {"value": 1}
    assert cached("cache_probe", key, lambda: compute(2)) == {"value": 1}
    assert calls == [1]
    other = ("inputs", np.arange(4).tobytes(), 4)
    assert cached("cache_probe", other, lambda: compute(3)) == {"value": 3}
    assert cached("cache_probe_b", key, lambda: compute(4)) == {"value": 4}
    assert calls == [1, 3, 4]


def test_array_key_sees_content_dtype_and_shape():
    a = np.arange(6, dtype=np.int32)
    assert array_key(a) == array_key(a.copy())
    assert array_key(torch.from_numpy(a)) == array_key(a)
    b = a.copy()
    b[3] += 1
    assert array_key(b) != array_key(a)
    assert array_key(a.astype(np.int64)) != array_key(a)
    assert array_key(a.reshape(2, 3)) != array_key(a)
    assert array_key(None) is None


def test_cached_jax_walks_equal_the_uncached_ones_and_miss_on_a_change():
    """The merge tests' cached JAX walks and merge return what the
    uncached calls compute; an operand changed in one BWT symbol keys
    another entry."""
    make, sigma_decl, r, srate, pack = tbm.CASES["sigma4"]
    _, _, jfms, _ = tbm._operands(make(), sigma_decl, r, srate, pack)
    assert np.array_equal(tbm._jax_kway_ins(jfms),
                          tbm._jax_kway_ins_computed(jfms))
    left, right = jfms[0], jfms[1]
    assert np.array_equal(tbm._jax_pair_ins(left, right),
                          tbm._jax_pair_ins_computed(left, right))
    merged = tbm._jax_merge(left, right, pack)
    tbm._same(tbm._carry(merged), tbm.jbm.merge_fm_indexes(left, right,
                                                           pack=pack))
    bwt = np.asarray(left.bwt).copy()
    bwt[left.length // 2] ^= 1
    changed = dataclasses.replace(left, bwt=tbm.jnp.asarray(bwt))
    assert tbm._fm_key(changed) != tbm._fm_key(left)
    hits = []
    got = cached("jax_pair_ins", (tbm._fm_key(changed), tbm._fm_key(right)),
                 lambda: hits.append(1) or "computed")
    assert got == "computed" and hits == [1]


def test_compile_cache_reads_back_a_program_and_misses_a_changed_one():
    """A program compiled anew at shapes compiled before is a cache hit
    (no new entry, the same values); the same program at another shape,
    or another program, is a miss that adds an entry."""
    import jax
    import jax.numpy as jnp
    from jax._src import monitoring

    path = Path(jax.config.jax_compilation_cache_dir)
    events = []

    def listen(event, **kw):
        events.append(event)

    def entries():
        # this program's entries only: the session's other workers write
        # to the same directory meanwhile
        return ({p.name for p in path.iterdir()
                 if p.name.startswith("jit_program-")}
                if path.exists() else set())

    def hits():
        return events.count("/jax/compilation_cache/cache_hits")

    def make(shift=1):
        # a new function object each call: jit's in-memory cache misses,
        # the program (named "program") is the same
        def program(x):
            return jnp.cumsum(x * 3 + shift) % 7
        return program

    def compiled(fn, x):
        return jax.jit(fn).lower(x).compile()

    monitoring.register_event_listener(listen)
    try:
        _hit_and_misses(make, compiled, entries, hits)
    finally:
        monitoring.unregister_event_listener(listen)


def _hit_and_misses(make, compiled, entries, hits):
    import jax.numpy as jnp

    # inputs put on the device up front: no other program is compiled
    # (and perhaps read back from the cache) between the counts
    x = jnp.asarray(np.arange(37, dtype=np.int32))
    y = jnp.asarray(np.arange(38, dtype=np.int32))
    first = np.asarray(compiled(make(), x)(x))
    after_first, hit = entries(), hits()
    again = np.asarray(compiled(make(), x)(x))
    assert hits() == hit + 1 and entries() == after_first
    assert np.array_equal(again, first)
    compiled(make(), y)
    after_shape = entries()
    assert hits() == hit + 1 and after_shape > after_first
    compiled(make(shift=2), x)
    assert hits() == hit + 1 and entries() > after_shape
