"""``Checkpointer.restore`` (``repro_torch/training/checkpoint.py``) and
the scenarios of ``tests/dist_driver.py`` that run beside a mesh, against
the JAX package's:

* ``elastic``: a state sharded over a gloo world of 8 ranks is gathered
  and saved, and a world of 4 restores it through ``Checkpointer.restore``
  with ``shardings`` (each rank its block of rows; a replicated leaf
  whole), each leaf recast to its template's dtype;
* ``seg_merge`` and ``crash_save``: a segmented catalog compacted k-way
  and by the rebuild, and crashed mid-save, on every rank of the world of
  4 (segments are single-device in both packages): the reference
  scenarios' own checks, and the answers and outcomes of the same
  scenario outside any world (the JAX package's compactions and crashed
  saves are held against the port's in ``test_torch_segments.py`` and
  ``test_torch_journal.py``);
* a distributed index save whose write fails on rank 0 (an ``io.write``
  fault armed on every rank): every rank raises, none waits forever, the
  previous step stays the latest and a retried save commits;
* the prefix-doubling state of ``tests/test_checkpoint.py`` saved mid-build
  and resumed through ``restore``, and checkpoints carried between the
  packages' ``restore``.

The JAX side runs in this process (no mesh: what it checks here does not
depend on the device count).  Exact equality throughout; the float
leaves are copied bit for bit.
"""

import os

import numpy as np
import pytest

WORLD_TIMEOUT_S = 120
DEVICES = 8            # the reference scenarios' device count (sizes)
SIGMA = 5


def state() -> dict:
    """The elastic scenario's state: two float32 [64, 32] leaves and a
    replicated step counter."""
    rng = np.random.default_rng(0)
    return {"w": rng.normal(size=(64, 32)).astype(np.float32),
            "m": rng.normal(size=(64, 32)).astype(np.float32),
            "step": np.int64(7)}


# --------------------------------------------------------------------------
# the catalog scenarios, run in a rank and outside any world
# --------------------------------------------------------------------------

def _catalog():
    from repro_torch.core.segments import SegmentedIndex

    return SegmentedIndex(SIGMA, sample_rate=8, sa_sample_rate=4,
                          device="cpu")


def _host(x) -> np.ndarray:
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _patterns(rng, full, B: int) -> np.ndarray:
    pats = np.full((B, 5), -1, np.int32)
    for b in range(B):
        m = int(rng.integers(1, 6))
        st = int(rng.integers(0, len(full) - m))
        pats[b, :m] = full[st: st + m]
    return pats


def seg_merge() -> dict:
    """``scenario_seg_merge``: four documents folded by one k-way walk and
    by the rebuild, then two more folded into a second multi-document
    segment and merged x merged; the answers, compaction counts,
    strategies and field differences along the way."""
    from repro_torch.core.fm_index import fm_mismatch

    rng = np.random.default_rng(41)
    chunks = [rng.integers(1, SIGMA, n).astype(np.int32)
              for n in (3 * DEVICES, 20, 7 * DEVICES, 33)]
    seg_m, seg_r = _catalog(), _catalog()
    for c in chunks:
        seg_m.append(c)
        seg_r.append(c)
    full = np.concatenate(chunks)
    pats = _patterns(rng, full, 12)
    k = 2 * len(full)
    out = {"count": _host(seg_m.count(pats))}
    pos, cnt = seg_m.locate(pats, k)
    out.update(pos=_host(pos), cnt=_host(cnt))

    out["kway"] = seg_m.compact(strategy="kway")
    out["rebuild"] = seg_r.compact(strategy="rebuild")
    out["fallbacks"] = seg_m.compact_fallbacks
    out["strategies"] = dict(seg_m.compact_strategy_counts)
    out["diff"] = fm_mismatch(seg_m.segments[0].index.fm,
                              seg_r.segments[0].index.fm)
    out["count_kway"] = _host(seg_m.count(pats))
    pos, cnt = seg_m.locate(pats, k)
    out.update(pos_kway=_host(pos), cnt_kway=_host(cnt))

    extra = [np.ones(34, np.int32),
             rng.integers(1, SIGMA, 21).astype(np.int32)]
    for s in (seg_m, seg_r):
        for c in extra:
            s.append(c)
    out["second"] = (seg_m.compact(min_tokens=60, strategy="kway"),
                     seg_r.compact(min_tokens=60, strategy="rebuild"))
    out["multi_doc"] = [s.multi_doc for s in seg_m.segments]
    out["plan_reason"] = seg_m._plan_run(seg_m.segments, "kway")[1]["reason"]
    before = _host(seg_m.count(pats))
    out["merged_x_merged"] = seg_m.compact(strategy="kway")
    out["fallbacks_after"] = seg_m.compact_fallbacks
    out["strategies_after"] = dict(seg_m.compact_strategy_counts)
    seg_r.compact(strategy="rebuild")
    out["diff_after"] = fm_mismatch(seg_m.segments[0].index.fm,
                                    seg_r.segments[0].index.fm)
    out["count_unchanged"] = bool(np.array_equal(_host(seg_m.count(pats)),
                                                 before))
    return out


def crash_save(root: str) -> dict:
    """``scenario_crash_save``: a catalog saved (generation 0), grown,
    crashed at the fourth ``io.write`` of its next save, reloaded, saved
    again; generations, answers and whether only committed files remain."""
    from repro_torch.core.journal import GenerationJournal as Journal
    from repro_torch.core.segments import SegmentedIndex as Seg
    from repro_torch.testing import faultinject

    rng = np.random.default_rng(53)
    seg = _catalog()
    chunks = [rng.integers(1, SIGMA, n).astype(np.int32)
              for n in (4 * DEVICES, 21, 40)]
    for c in chunks[:2]:
        seg.append(c)
    pats = _patterns(rng, np.concatenate(chunks[:2]), 8)
    out = {"count": _host(seg.count(pats))}
    d = os.path.join(root, "catalog")
    seg.save(d)
    seg.append(chunks[2])
    faultinject.arm(faultinject.FaultSchedule.parse("io.write:3"))
    try:
        seg.save(d)
        out["crash"] = None
    except faultinject.InjectedFault as e:
        out["crash"] = str(e)
    finally:
        faultinject.arm(None)
    back = Seg.load(d, device="cpu")
    man = Journal(d).committed()
    out.update(generation=man["generation"], degraded=back.degraded,
               tokens=back.total_tokens, count_back=_host(back.count(pats)))
    on_disk = {os.path.relpath(os.path.join(r, f), d).replace(os.sep, "/")
               for r, _, fs in os.walk(d) for f in fs}
    out["only_committed_files"] = on_disk == set(man["files"]) | {
        "CURRENT", "catalog.json", f"gen_{man['generation']:08d}.json"}
    seg.save(d)
    again = Seg.load(d, device="cpu")
    out.update(generation_again=Journal(d).committed()["generation"],
               tokens_again=again.total_tokens,
               count_again=_host(again.count(pats)))
    return out


# --------------------------------------------------------------------------
# the ranks
# --------------------------------------------------------------------------

def save_rank(mesh, root: str) -> int:
    """World of 8: this rank's block of rows of each leaf (its shard),
    gathered to rank 0, which saves the whole state, "m" as bf16; every
    rank waits for the write."""
    import torch

    from repro_torch.core import dist_sort as ds
    from repro_torch.training.checkpoint import Checkpointer

    st = state()
    info = ds.shard_info(mesh, st["w"].shape[0])
    lo = ds._me(info) * info.part_size
    full = {}
    for k in ("w", "m"):
        shard = torch.from_numpy(st[k][lo: lo + info.part_size])
        g = ds.gather(info, shard)
        full[k] = None if g is None else g.reshape(st[k].shape)
    if full["w"] is not None:
        full["m"] = full["m"].to(torch.bfloat16)
        full["step"] = torch.tensor(st["step"])
        Checkpointer(root).save(5, full, extra={"mesh": str(info.parts)})
    ds.pmax(info, torch.zeros(1))            # the write is done
    return ds._me(info)


def restore_rank(mesh, root: str) -> dict:
    """World of 4: the elastic restore (rows split over the mesh, the step
    replicated, each leaf recast to its template's dtype), both catalog
    scenarios, and a distributed index save crashed on rank 0."""
    import torch

    from repro_torch.core.index_io import (
        latest_index_step,
        restore_index,
        save_index,
    )
    from repro_torch.core.pipeline import build_index
    from repro_torch.testing import faultinject
    from repro_torch.training.checkpoint import Checkpointer

    me = mesh.get_local_rank("parts")
    tmpl = {"w": torch.zeros(64, 32, dtype=torch.float64),
            "m": torch.zeros(64, 32, dtype=torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}
    tree, meta = Checkpointer(root).restore(
        tmpl, shardings={"w": (mesh, 0), "m": (mesh, 0), "step": None})
    out = {"meta": meta,
           "dtypes": {k: str(v.dtype) for k, v in tree.items()},
           "shapes": {k: tuple(v.shape) for k, v in tree.items()},
           "w": tree["w"], "m": tree["m"].float(), "step": tree["step"]}

    mine = os.path.join(root, f"rank_{me}")
    out["seg_merge"] = seg_merge()
    out["crash_save"] = crash_save(mine)

    toks = np.random.default_rng(7).integers(1, SIGMA, 4000).astype(np.int32)
    kw = dict(sample_rate=8, sa_sample_rate=4, device="cpu")
    old = build_index(toks, mesh, **kw)
    new = build_index(toks[::-1].copy(), mesh, **kw)
    pats = _patterns(np.random.default_rng(8), toks, 8)
    d = os.path.join(root, "dist_index")
    save_index(d, old, step=0)
    faultinject.arm(faultinject.FaultSchedule.parse("io.write:0"))
    try:
        save_index(d, new, step=1)
        out["dist_crash"] = None
    except Exception as e:
        out["dist_crash"] = f"{type(e).__name__}: {e}"
    finally:
        faultinject.arm(None)
    out["latest_after_crash"] = latest_index_step(d)
    out["restored_old"] = bool(torch.equal(
        restore_index(d, mesh, device="cpu").count(pats), old.count(pats)))
    out["retry_step"] = save_index(d, new, step=1)
    out["restored_new"] = bool(torch.equal(
        restore_index(d, mesh, device="cpu").count(pats), new.count(pats)))
    return out


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    from repro_torch.launch.mesh import run_world

    root = str(tmp_path_factory.mktemp("elastic"))
    saved = run_world(8, save_rank, root, timeout_s=WORLD_TIMEOUT_S)
    restored = run_world(4, restore_rank, root, timeout_s=WORLD_TIMEOUT_S)
    return root, saved, restored


def test_eight_ranks_save_and_four_restore(worlds):
    """Each rank of 4 holds its 16 rows of the state 8 ranks saved, in its
    template's dtypes; the replicated step whole on every rank."""
    import torch

    _, saved, restored = worlds
    st = state()
    assert saved == list(range(8))
    for me, r in enumerate(restored):
        assert r["meta"] == {"step": 5, "mesh": "8"}
        assert r["dtypes"] == {"w": "torch.float64", "m": "torch.bfloat16",
                               "step": "torch.int32"}
        assert r["shapes"] == {"w": (16, 32), "m": (16, 32), "step": ()}
        rows = slice(16 * me, 16 * (me + 1))
        assert np.array_equal(r["w"], st["w"][rows].astype(np.float64))
        m16 = torch.from_numpy(st["m"][rows]).to(torch.bfloat16).float()
        assert np.array_equal(r["m"], m16.numpy())
        assert r["step"] == 7


def test_the_elastic_checkpoint_restores_in_jax(worlds):
    """The JAX package's ``restore`` reads the port's checkpoint (its bf16
    leaf stored as float32) into the same values."""
    import jax.numpy as jnp

    from repro.training.checkpoint import Checkpointer as JCheckpointer

    root = worlds[0]
    tmpl = {"w": jnp.zeros((64, 32), jnp.float32),
            "m": jnp.zeros((64, 32), jnp.bfloat16),
            "step": jnp.zeros((), jnp.int32)}
    tree, meta = JCheckpointer(root).restore(tmpl)
    st = state()
    assert meta == {"step": 5, "mesh": "8"}
    assert np.array_equal(np.asarray(tree["w"]), st["w"])
    assert tree["m"].dtype == jnp.bfloat16
    assert np.array_equal(np.asarray(tree["m"], np.float32),
                          np.asarray(jnp.asarray(st["m"], jnp.bfloat16),
                                     np.float32))
    assert int(tree["step"]) == 7


def _same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            assert np.array_equal(got[k], v), k
        else:
            assert got[k] == v, k


def test_seg_merge_in_a_world_as_outside(worlds):
    """Inside the world as outside it: one k-way walk folds the catalog
    with no fallback, equal to the rebuild; merged x merged folds
    rebuild-free; answers unchanged by every compaction."""
    want = seg_merge()
    assert want["kway"] == 1 and want["fallbacks"] == 0
    assert want["strategies_after"] == {"kway": 3}
    assert want["diff"] == want["diff_after"] == []
    assert want["plan_reason"] is None and all(want["multi_doc"])
    assert want["count_unchanged"]
    for r in worlds[2]:
        _same(r["seg_merge"], want)


def test_crash_save_in_a_world_as_outside(worlds, tmp_path):
    """Inside the world as outside it: the torn save leaves generation 0
    committed and only its files; the retry commits generation 1."""
    want = crash_save(str(tmp_path))
    assert want["crash"] is not None and want["generation"] == 0
    assert not want["degraded"] and want["only_committed_files"]
    assert want["generation_again"] == 1
    assert np.array_equal(want["count_back"], want["count"])
    for r in worlds[2]:
        _same(r["crash_save"], want)


def test_a_failed_distributed_save_fails_every_rank(worlds):
    """The writer raises its fault, the other ranks a RuntimeError naming
    it; the earlier step serves; the retry commits step 1."""
    for me, r in enumerate(worlds[2]):
        if me == 0:
            assert r["dist_crash"].startswith("InjectedFault")
        else:
            assert r["dist_crash"].startswith(
                "RuntimeError: rank 0 failed to write index checkpoint "
                "step 1")
        assert r["latest_after_crash"] == 0 and r["restored_old"]
        assert r["retry_step"] == 1 and r["restored_new"]


def test_index_build_state_checkpoint(tmp_path):
    """``tests/test_checkpoint.py::TestResume``: the prefix-doubling loop
    state saved after three rounds, restored through ``restore`` and run
    to the end equals the uninterrupted run and the JAX package's ISA."""
    import torch

    from repro.core.suffix_array import isa_prefix_doubling as j_isa
    from repro_torch.core import alphabet as al
    from repro_torch.core.suffix_array import (
        initial_ranks,
        rerank_from_sorted,
        shifted_ranks,
    )
    from repro_torch.training.checkpoint import Checkpointer

    rng = np.random.default_rng(0)
    s = al.append_sentinel(rng.integers(1, 5, 63).astype(np.int32))
    sd = torch.from_numpy(s)
    n = len(s)

    def one_round(rank, h):
        r2 = shifted_ranks(rank, h)
        order = torch.from_numpy(np.lexsort((r2.numpy(), rank.numpy())))
        new_sorted, _ = rerank_from_sorted(rank[order], r2[order])
        return torch.zeros_like(rank).index_put_((order,), new_sorted)

    rank, h = initial_ranks(sd, al.sigma_of(s)), 1
    for _ in range(3):
        rank, h = one_round(rank, h), h * 2
    ck = Checkpointer(str(tmp_path))
    ck.save(3, {"rank": rank}, extra={"h": h})
    restored, meta = ck.restore({"rank": torch.zeros_like(rank)})
    rank2, h2 = restored["rank"], meta["h"]
    assert rank2.dtype == rank.dtype and torch.equal(rank2, rank)
    while h2 < n:
        rank2, h2 = one_round(rank2, h2), h2 * 2
    ref, h = initial_ranks(sd, al.sigma_of(s)), 1
    while h < n:
        ref, h = one_round(ref, h), h * 2
    assert torch.equal(rank2, ref)
    assert np.array_equal(rank2.numpy(), np.asarray(j_isa(s, al.sigma_of(s))))


def test_a_jax_checkpoint_restores_through_the_port(tmp_path):
    """The port's ``restore`` of a JAX save: nested dicts and lists, a bf16
    leaf (float32 on disk), a missing leaf's ``KeyError``; a sharding on a
    non-mesh is refused."""
    import jax.numpy as jnp
    import torch

    from repro.training.checkpoint import Checkpointer as JCheckpointer
    from repro_torch.training.checkpoint import Checkpointer

    st = state()
    JCheckpointer(str(tmp_path)).save(2, {
        "opt": {"m": jnp.asarray(st["m"], jnp.bfloat16),
                "w": [jnp.asarray(st["w"]), jnp.arange(5)]}})
    tmpl = {"opt": {"m": torch.zeros(64, 32, dtype=torch.bfloat16),
                    "w": [torch.zeros(64, 32), np.zeros(5, np.int64)]}}
    tree, meta = Checkpointer(str(tmp_path)).restore(tmpl)
    assert meta == {"step": 2}
    assert tree["opt"]["m"].dtype == torch.bfloat16
    assert torch.equal(tree["opt"]["m"],
                       torch.from_numpy(st["m"]).to(torch.bfloat16))
    assert torch.equal(tree["opt"]["w"][0], torch.from_numpy(st["w"]))
    assert tree["opt"]["w"][1].dtype == torch.int64
    assert tree["opt"]["w"][1].tolist() == list(range(5))
    with pytest.raises(KeyError, match="opt/v"):
        Checkpointer(str(tmp_path)).restore({"opt": {"v": torch.zeros(1)}})
    with pytest.raises(TypeError, match="DeviceMesh"):
        Checkpointer(str(tmp_path)).restore(
            tmpl, shardings={"opt": {"m": (object(), 0), "w": [None, None]}})
