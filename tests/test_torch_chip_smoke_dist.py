"""chip_smoke.py's phase 10 (the distributed build, query, save and
restore) rehearsed on the CPU in gloo worlds at a tiny size, a rank that
raises failing it, and its checks refusing any difference.  No GPU.
(Moved from ``test_torch_chip_smoke.py``, whose one worker ran them all.)
"""

import pytest
import torch
from torch_session_cache import load_chip_smoke


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation, which turns into many times the work
    when the host's cores are shared with the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# one module per process: the functions handed to spawned ranks must be the
# ones the ranks import by the name chip_smoke
chip_smoke = load_chip_smoke()


# -- phase 10: the distributed build and query ----------------------------

def _phase_dist_cpu(**kw):
    from repro_torch.data.corpus import corpus

    return chip_smoke.phase_dist(
        corpus("dna", 1 << 12), {}, dna_log2n=12, proteins_log2n=11,
        small_dna_log2n=11, small_proteins_log2n=10, device="cpu",
        parts=(2,), requests=32, launcher_log2n=12, **kw)


@pytest.fixture(scope="module")
def phase_dist_cpu():
    return _phase_dist_cpu()


RESTORE_PATHS = ("dist_restore_dist_on_one_device",
                 "dist_restore_dist_on_mesh", "dist_restore_fm_on_mesh",
                 "dist_p2_restore", "dist_restore_one_device")


def test_phase_dist_runs_on_the_cpu(phase_dist_cpu):
    """Phase 10 at a tiny size on the CPU (plain versions, no launch):
    every distributed build equals its single-device build and answers,
    one rank in this process and two in a gloo world; the overflowing
    samplesort start overflows and retries; the served batches make the
    reference's collectives (two psums a pattern position; locate adds
    two a walk step) and no other."""
    rec, launches, rows = phase_dist_cpu
    assert rec["transport_p1"] == rec["p2"]["transport"] == "gloo, direct"
    assert rows == {} and "nccl_two_ranks_one_card" not in rec
    assert all(set(v.values()) == {0} for v in launches.values())
    assert set(launches) == (
        {f"dist_p1_{k}" for k in ("dna", "dna_samplesort", "proteins")}
        | {f"dist_p2_{k}" for k in chip_smoke.dist_builds(11, 10)}
        | set(RESTORE_PATHS))
    paths = [rec["p1_dna"], rec["p1_dna_samplesort"], rec["p1_proteins"],
             *(rec["p2"][k] for k in chip_smoke.dist_builds(11, 10))]
    for r in paths:
        L = r["count"]["batch"][1]
        assert r["count"]["collectives"] == {
            "all_gather": 0, "gather": 0, "ppermute": 0, "all_to_all": 0,
            "psum": 2 * L, "pmax": 0}
        assert r["locate"]["collectives"]["psum"] == 2 * L + 2 * 32
        assert r["collectives_build"]["all_gather"] > 0
    assert rec["p1_dna_samplesort"]["collectives_build"]["all_to_all"] > 0
    assert rec["p2"]["dna_overflow"]["first_attempt_overflowed"] is True
    assert rec["p2"]["dna_overflow"]["capacity_factor"] == 0.5
    rounds = rec["p1_dna"]["isa_rounds"]
    assert rounds["remaining"][-1] == 0
    assert len(rounds["round_s"]) == len(rounds["remaining"]) - 1
    assert set(rec["p1_dna"]["stages_s"]) == {
        "prepare_tokens_host", "host_to_device", "isa", "bwt", "fm_build"}


def test_phase_dist_restores_on_the_cpu(phase_dist_cpu):
    """Phase 10's checkpoints at a tiny size on the CPU: (a) the one-rank
    DNA mesh index saved and restored on one device and onto the mesh,
    and a single-device checkpoint onto the mesh, each answering as the
    single-device build (checked inside), timed beside the mesh build;
    (b) the world's saved build restored in the world (the last one) and
    on one device; (c) the launcher as a world of 2, built and restored,
    with one total_hits printed by rank 0 alone."""
    rec, launches, _ = phase_dist_cpu
    p1 = rec["p1_restore"]
    assert p1["mesh_build_s"] == rec["p1_dna"]["build_s"]
    assert p1["save_s"] > 0 and p1["read_npz_s"] > 0
    assert p1["bytes_on_disk"] > 4 << 12
    L = rec["p1_dna"]["count"]["batch"][1]      # the requests' width
    for name in ("dist_on_one_device", "dist_on_mesh", "fm_on_mesh"):
        r = p1[name]
        assert r["restore_s"] > 0 and r["bits"] == 4
        assert r["peak_mem_gib"] is None
        mesh = name.endswith("mesh")
        # the mesh restore's symbol totals: one psum
        assert r["collectives_restore"]["psum"] == int(mesh)
        assert r["count"]["collectives"]["psum"] == 2 * L * mesh
    assert rec["p2"]["dna_bitonic"]["save_s"] > 0
    assert rec["p2"]["restore"]["collectives_restore"]["psum"] == 1
    assert rec["restore_one_device"]["collectives_restore"]["psum"] == 0
    built, restored = rec["launcher"]["build"], rec["launcher"]["restore"]
    assert built["total_hits"] == restored["total_hits"] > 0
    assert built["located"] == restored["located"] > 0
    assert any("2 ranks (gloo)" in line for line in built["lines"])
    assert any("restored dist_fm index" in line
               for line in restored["lines"])


def test_check_restored_refuses_any_difference():
    import numpy as np

    ref = dict(counts=np.ones(4), pos=np.zeros((4, 2)), cnt=np.ones(4))
    got = chip_smoke._host_answers(*ref.values())
    chip_smoke.check_restored(got, ref, "same")
    for key in ref:
        bad = dict(got, **{key: got[key] + 1})
        with pytest.raises(AssertionError, match=f"{key} differ"):
            chip_smoke.check_restored(bad, ref, "x")


def test_restore_launches_required_on_the_card_only():
    """On the card a restore launches char_histogram and its queries the
    rank kernel of a mesh index (the fused kernel on one device); on the
    CPU nothing launches."""
    zero = dict.fromkeys(("char_histogram", "rank_packed", "rank_select",
                          "fm_query_packed"), 0)
    rec = {"bits": 4, "launches_restore": dict(zero, char_histogram=1),
           "launches_queries": dict(zero, rank_packed=64)}
    chip_smoke.require_restore_launches(rec, object(), True, "ok")
    with pytest.raises(AssertionError, match="fm_query_packed never"):
        chip_smoke.require_restore_launches(rec, None, True, "x")
    with pytest.raises(AssertionError, match="char_histogram never"):
        chip_smoke.require_restore_launches(
            dict(rec, launches_restore=zero), object(), True, "x")
    with pytest.raises(AssertionError, match="launched on the CPU"):
        chip_smoke.require_restore_launches(rec, object(), False, "x")
    chip_smoke.require_restore_launches(
        dict(rec, launches_restore=zero, launches_queries=zero), None,
        False, "ok")


def failing_dist_rank(mesh, spec):
    """``chip_smoke.dist_rank`` on every rank but rank 1, which raises."""
    if mesh.get_local_rank("parts") == 1:
        raise RuntimeError("rank 1 lost its card")
    return chip_smoke.dist_rank(mesh, spec)


def test_phase_dist_fails_when_a_rank_raises():
    """A rank's exception fails the phase with that rank's traceback (the
    script then exits nonzero); the waiting rank does not hang it."""
    with pytest.raises(RuntimeError, match="rank 1 raised") as err:
        _phase_dist_cpu(rank_fn=failing_dist_rank)
    assert "rank 1 lost its card" in str(err.value)


def test_same_dist_refuses_any_difference():
    import numpy as np

    ref = dict(sa=np.arange(8), bwt=np.arange(8) % 3, row=2,
               counts=np.ones(4), pos=np.zeros((4, 2)), cnt=np.ones(4))
    rec = dict(ref)
    chip_smoke.same_dist(rec, *ref.values(), "same")
    for key, bad in (("sa", np.arange(8)[::-1]), ("row", 3),
                     ("cnt", np.zeros(4))):
        with pytest.raises(AssertionError, match="differ"):
            chip_smoke.same_dist({**rec, key: bad}, *ref.values(), "x")


def test_dist_launches_required_on_the_card_only():
    need = dict.fromkeys(chip_smoke.DIST_NEEDED["dna"], 1)
    chip_smoke.require_dist_launches({**need, "rerank_scan": 0}, "dna",
                                     True, "ok")
    with pytest.raises(AssertionError, match="rank_packed never launched"):
        chip_smoke.require_dist_launches({**need, "rank_packed": 0}, "dna",
                                         True, "x")
    with pytest.raises(AssertionError, match="launched on the CPU"):
        chip_smoke.require_dist_launches(need, "dna", False, "x")
