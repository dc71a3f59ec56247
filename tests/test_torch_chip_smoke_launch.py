"""chip_smoke.py's phase 13 checks on the production mesh cells and the
peaks it holds (index builds and worlds against their meta estimates),
and all 80 mesh cells rehearsed on the CPU.  No GPU.  (Moved from
``test_torch_chip_smoke.py``, whose one worker ran them all.)
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


# --------------------------------------------------------------------------
# phase 13's production mesh cells and the world peaks it holds
# --------------------------------------------------------------------------

def _mesh_cell(**kw):
    rec = {"counts": {"flops": 10, "bytes": 20}, "split_axes": ["model"],
           "collectives": {"moved_bytes": 30}}
    rec.update(kw)
    return rec


def test_check_mesh_cell_refuses_broken_readings():
    """A traced mesh cell that counts no work, or whose collectives move
    nothing where its rules split a weight over an axis, fails; a cell
    whose rules split nothing may move nothing."""
    chip_smoke.check_mesh_cell(_mesh_cell(), "ok")
    chip_smoke.check_mesh_cell(
        _mesh_cell(split_axes=[], collectives={"moved_bytes": 0}), "unsplit")
    with pytest.raises(AssertionError, match="move 0 bytes"):
        chip_smoke.check_mesh_cell(
            _mesh_cell(collectives={"moved_bytes": 0}), "silent")
    with pytest.raises(AssertionError, match="no FLOPs or bytes"):
        chip_smoke.check_mesh_cell(
            _mesh_cell(counts={"flops": 0, "bytes": 20}), "idle")


def test_mesh_cells_all_80_on_the_cpu(tmp_path, monkeypatch):
    """Phase 13's mesh checks over every cell (``dryrun.main --multi-pod
    both``, the separate command) at reduced configs and shorter
    sequences: 32 traced and 8 skipped per mesh, the four bwt_index cells
    traced at n = 2^16 and passing phase 13's index checks, each traced
    cell moving collective bytes; a cell whose step gathers nothing where
    its rules split a weight, or traced where the reference skips it, is
    refused."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.configs.bwt_index import reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import SHAPES

    for name, seq in (("train_4k", 64), ("prefill_32k", 256),
                      ("decode_32k", 128), ("long_500k", 256)):
        monkeypatch.setitem(SHAPES, name, dict(SHAPES[name], seq_len=seq))
    recs = dryrun.main(["--out", str(tmp_path), "--multi-pod", "both"],
                       config_of=get_reduced_config,
                       index_cfg=reduced().replace(n=1 << 16))
    lm = [r for r in recs if r["arch"] != "bwt_index"]
    out = chip_smoke.check_mesh_cells(lm, get_reduced_config)
    assert len(out) == chip_smoke.LAUNCH_MESH_CELLS
    traced = [v for v in out.values() if v["status"] == "traced"]
    assert len(traced) == 64
    assert all(v["collective_bytes"] > 0 and v["flops"] > 0 for v in traced)
    assert {v["chips"] for v in traced} == {256, 512}
    assert len(list(tmp_path.glob("*__16x16.json"))) == 42
    index = [r for r in recs if r["arch"] == "bwt_index"]
    assert [tuple(r[k] for k in ("arch", "shape", "mesh")) for r in index
            ] == list(chip_smoke.INDEX_MESH_CELLS)
    assert [r["status"] for r in index] == ["traced"] * 4
    summary = chip_smoke.check_index_mesh_cells(index)
    assert {v["chips"] for v in summary.values()} == {256, 512}
    assert all(v["collective_bytes"] > 0 for v in summary.values())
    # a world step whose collectives moved nothing is not the sharded
    # step; a cell traced where the reference skips it is refused
    rec = dryrun.run_cell("qwen2p5_3b", "decode_32k", mesh="16x16",
                          config_of=get_reduced_config)
    chip_smoke.check_mesh_cells([rec], get_reduced_config)
    rec["collectives"]["moved_bytes"] = 0
    with pytest.raises(AssertionError, match="move 0 bytes"):
        chip_smoke.check_mesh_cells([rec], get_reduced_config)
    with pytest.raises(AssertionError, match="long_500k x 16x16: traced"):
        chip_smoke.check_mesh_cells([dict(rec, shape="long_500k")],
                                    get_reduced_config)


@pytest.mark.parametrize("arch,shape,mesh", [
    ("qwen2p5_3b", "decode_32k", "16x16"),
    ("deepseek_v2_236b", "decode_32k", "2x16x16"),
    ("recurrentgemma_2b", "long_500k", "16x16")])
def test_check_mesh_cells_refuses_a_cache_not_in_the_references_layout(
        arch, shape, mesh):
    """Phase 13 on a decode cell (reduced configs, the shape's own
    sequence): the rank's attention caches hold what the reference's
    layout gives it (the sequence over model), which passes; a record
    whose rank holds more (the whole sequence, as a world that splits the
    kv heads instead would) is refused."""
    import copy

    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import dryrun

    rec = dryrun.run_cell(arch, shape, mesh=mesh,
                          config_of=get_reduced_config)
    got = rec["attention_cache_bytes"]
    assert got["held"] == got["argument"] > 0
    chip_smoke.check_mesh_cells([rec], get_reduced_config)
    whole = copy.deepcopy(rec)
    whole["attention_cache_bytes"]["held"] *= 16
    with pytest.raises(AssertionError, match="attention cache"):
        chip_smoke.check_mesh_cells([whole], get_reduced_config)


def test_check_index_mesh_cells_refuses_broken_readings():
    """An index mesh cell that is not traced, counts none of its kernels'
    bytes, moves no collective bytes or does not fit one card fails."""
    def cell(shape="build", **kw):
        rec = {"arch": "bwt_index", "shape": shape, "mesh": "16x16",
               "status": "traced", "chips": 256, "part_size": 4,
               "argument_bytes": {}, "held_argument_bytes": {},
               "trace_s": 0.1,
               "counts": {"bytes": 9, "kernel_bytes": {
                   "radix_hist": 1, "radix_pos": 2, "rank_select": 3}},
               "collectives": {"moved_bytes": 8, "calls": {"psum": 1}},
               "memory": {"fits": True, "temp_size_in_bytes": 1,
                          "total_bytes": 2},
               "roofline": {"memory_s": 1.0, "collective_s": 0.5,
                            "bottleneck": "memory"}}
        rec.update(kw)
        return rec

    out = chip_smoke.check_index_mesh_cells([cell(), cell("serve")])
    assert sorted(out) == ["bwt_index__build__16x16",
                           "bwt_index__serve__16x16"]
    for bad, match in (
            (cell(status="failed", error="boom"), "failed"),
            (cell(counts={"bytes": 1, "kernel_bytes": {"radix_hist": 1}}),
             "no radix_pos bytes"),
            (cell("serve", counts={"bytes": 1, "kernel_bytes": {}}),
             "no rank_select bytes"),
            (cell(collectives={"moved_bytes": 0, "calls": {}}),
             "move 0 bytes"),
            (cell(memory={"fits": False, "temp_size_in_bytes": 1,
                          "total_bytes": 2}), "does not fit")):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_index_mesh_cells([bad])


def test_index_peaks_are_held_to_their_meta_estimates():
    """(a) phase 13's one-rank build peak and (b) the largest of phase 10
    (b)'s build peaks a rank in its world of 4, against ISA builds traced
    in meta worlds of 1 and 4 (small texts) for ``INDEX_PEAK_ROUNDS``
    rounds, whose peak is the whole budget's: from 0.90 to 1.10 x the
    estimate passes, outside it fails, and a reading the CPU does not
    take (None) is not held."""
    from repro_torch.configs.bwt_index import CONFIG, reduced
    from repro_torch.launch import dryrun

    est = {"isa_one_rank": chip_smoke.isa_estimate(1, reduced()),
           "isa_world": chip_smoke.isa_estimate(
               4, None, "proteins", 12)}
    one, world = est["isa_one_rank"], est["isa_world"]
    assert (one["parts"], one["n"], one["kind"]) == (1, 1 << 12, "english")
    assert world["parts"] == chip_smoke.INDEX_PEAK_WORLD[1] == 4
    assert world["n"] == (1 << 12) + 256 and world["sigma"] == 23
    for e in (one, world):
        assert e["total_bytes"] == e["argument_bytes"] + e["temp_bytes"] > 0
        assert e["rounds_traced"] > 0
    assert world["collective_bytes"] > 0
    for e, icfg in ((one, reduced()),
                    (world, CONFIG.replace(n=world["n"],
                                           sigma=world["sigma"]))):
        full = dryrun.trace_index_mesh_cell("build", e["parts"], icfg)
        assert e["rounds_traced"] == chip_smoke.INDEX_PEAK_ROUNDS
        assert full["rounds_traced"] > chip_smoke.INDEX_PEAK_ROUNDS
        assert e["total_bytes"] == full["memory"]["total_bytes"]
    got = chip_smoke.check_index_peaks(
        est, 1.1 * one["total_bytes"],
        [0.5 * world["total_bytes"], world["total_bytes"]])
    assert got["isa_one_rank"]["ratio"] == pytest.approx(1.1)
    assert got["isa_world"]["ratio"] == pytest.approx(1.0)
    assert len(got["isa_world"]["measured_bytes_per_rank"]) == 2
    assert chip_smoke.check_index_peaks(est, None, None) == {}
    with pytest.raises(AssertionError, match="one-rank build peak"):
        chip_smoke.check_index_peaks(est, 1.11 * one["total_bytes"], None)
    with pytest.raises(AssertionError, match="world of 4"):
        chip_smoke.check_index_peaks(est, None,
                                     [1.2 * world["total_bytes"]])
    with pytest.raises(AssertionError, match="one-rank build peak.* under"):
        chip_smoke.check_index_peaks(est, 0.89 * one["total_bytes"], None)
    with pytest.raises(AssertionError, match="world of 4"):
        chip_smoke.check_index_peaks(est, None,
                                     [0.8 * world["total_bytes"]])


def test_world_peaks_are_held_to_their_meta_estimates():
    """Phases 14 (b) and 15 (b) traced for rank 0 in meta worlds (reduced
    configs): a measured step peak from 0.90 to 1.10 x the estimate
    passes, one outside it fails."""
    est = chip_smoke.world_peak_estimates("get_reduced_config")
    train, serve = est["lm_world_train"], est["lm_world_full"]
    assert train["mesh"] == chip_smoke.LM_TRAIN_WORLD["mesh"]
    assert serve["mesh"] == chip_smoke.LM_WORLD_FULL_MESH
    assert serve["kind"] in ("prefill", "decode")
    assert serve["total_bytes"] >= serve["other_total_bytes"]
    for e in (train, serve):
        assert e["total_bytes"] == e["argument_bytes"] + e["temp_bytes"] > 0
        assert e["collective_bytes"] > 0
    gib = 2**30

    def records(t, s):
        served = {serve["arch"]: {"ranks": [
            {"step_peak_gib": s * serve["total_bytes"] / gib},
            {"step_peak_gib": 0.5 * serve["total_bytes"] / gib}]}}
        trained = {"step_peak_gib_per_rank": [
            t * train["total_bytes"] / gib, 0.0]}
        return served, trained

    got = chip_smoke.check_world_peaks(est, *records(1.0, 1.1))
    assert got["lm_world_full"]["ratio"] == pytest.approx(1.1)
    assert got["lm_world_train"]["ratio"] == pytest.approx(1.0)
    assert chip_smoke.check_world_peaks(est, None, None) == {}
    for t, s, match in ((1.0, 1.11, "phase 14"), (1.2, 1.0, "phase 15"),
                        (1.0, 0.89, "phase 14 .* under"),
                        (0.85, 1.0, "phase 15 .* under")):
        with pytest.raises(AssertionError, match=match):
            chip_smoke.check_world_peaks(est, *records(t, s))
