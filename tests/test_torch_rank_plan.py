"""The unpacked single-batch rank kernel's host side
(``kernels/rank_select.py``): its launch plan (lanes a query, queries a
warp, grid) by hand, the C arguments the wrapper passes against the
argument types it declares and the parameters of the entries in
``csrc/rank_select.cu`` (a file read, no nvcc), a model of the kernel's
lanes in plain Python (every symbol below the cut counted once, every
query answered once) against the plain version, and the LF-map rank batch
that chip_smoke.py's phase 7 observes.  The kernel's answers are held to
the JAX package in ``test_torch_kernels.py`` (CPU: the plain version) and
to the plain version on the card by chip_smoke.py phase 1.
"""

import importlib.util
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels import rank_select as rk

RESIDENT = 1056    # blocks of 256 threads an H100 holds at 8 a SM


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation when the host's cores are shared with
    the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("B, r, resident, group, per_warp, grid", [
    (16384, 64, RESIDENT, 8, 4, 512),      # the locate walk: one wave
    (1024, 64, RESIDENT, 8, 4, 32),        # a search batch
    (655360, 64, RESIDENT, 4, 8, RESIDENT),  # an LF map: grid-stride
    (1, 64, RESIDENT, 8, 4, 1),
    (7, 7, RESIDENT, 4, 8, 1),             # r not a multiple of 4
    (100, 30, 10, 4, 8, 2),
    (16384, 32, RESIDENT, 4, 8, 256),
    (16384, 128, RESIDENT, 16, 2, 1024),
    (16384, 512, RESIDENT, 16, 2, 1024),   # 32 lanes would take 2 waves
    (8192, 512, RESIDENT, 32, 1, 1024),
    (34000, 64, RESIDENT, 4, 8, 532),      # 8 lanes would take 1063 blocks
    (5000, 2048, 3, 4, 8, 3),              # past one step a lane
])
def test_plan_by_hand(B, r, resident, group, per_warp, grid):
    assert rk.rank_select_plan(B, r, resident) == {
        "group": group, "queries_per_warp": per_warp, "grid": grid}


@pytest.mark.parametrize("group", rk.GROUPS)
def test_plan_takes_a_forced_group(group):
    plan = rk.rank_select_plan(16384, 64, RESIDENT, group)
    assert plan == {"group": group, "queries_per_warp": 32 // group,
                    "grid": min(16384 * group // rk.THREADS, RESIDENT)}


@pytest.mark.parametrize("group", [0, 2, 12, 64])
def test_plan_refuses_a_group_the_kernel_lacks(group):
    with pytest.raises(ValueError, match="group"):
        rk.rank_select_plan(1024, 64, RESIDENT, group)


def test_plan_is_one_wave_that_covers_the_batch():
    for B in (1, 7, 31, 1024, 16384, 34000, 655360):
        for r in (1, 4, 7, 32, 33, 64, 100, 128, 256, 512, 4096):
            for resident in (1, 132, RESIDENT):
                p = rk.rank_select_plan(B, r, resident)
                G, wave = p["group"], resident * rk.THREADS
                assert G in rk.GROUPS and p["queries_per_warp"] * G == 32
                # the fewest lanes whose 8 symbols each cover the block
                assert rk.rank_group(r) == 4 or 8 * rk.rank_group(r) // 2 < r
                assert 8 * rk.rank_group(r) >= r or rk.rank_group(r) == 32
                # ... unless the batch's lanes would pass one wave
                assert G == rk.rank_group(r) or (
                    B * 2 * G > wave and (G == 4 or B * G <= wave))
                assert 1 <= p["grid"] <= resident
                groups = p["grid"] * rk.THREADS // G
                assert groups >= B or p["grid"] == resident
                assert groups - rk.THREADS // G < B


def _c_params(entry: str) -> int:
    src = (_build.CSRC / "rank_select.cu").read_text()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
    assert m, entry
    return len(m.group(1).split(","))


def test_declared_argument_types_match_the_source():
    assert len(_build.SIGNATURES["rank_select"]) == _c_params(
        "rank_select_launch")


def test_occupancy_query_matches_the_source():
    assert len(rk.OCCUPANCY_ARGTYPES) == _c_params("rank_select_occupancy")


def test_source_builds_every_planned_group():
    src = (_build.CSRC / "rank_select.cu").read_text()
    assert [int(g) for g in re.findall(r"case (\d+): return kernel_of",
                                       src)] == list(rk.GROUPS)
    assert f"THREADS = {rk.THREADS};" in src


def _blocks(nb=40, r=64, sigma=23, seed=0, offset=0):
    g = torch.Generator().manual_seed(seed)
    flat = torch.randint(0, sigma, (nb * r + offset,), generator=g,
                         dtype=torch.int32)
    return flat[offset:].view(nb, r)


def test_vector_loads_need_an_aligned_base_and_whole_chunks():
    assert rk.vector_loads(_blocks())
    assert not rk.vector_loads(_blocks(offset=1))    # 4 bytes off
    assert not rk.vector_loads(_blocks(r=7))
    assert rk.vector_loads(_blocks(offset=4))       # 16 bytes off


def _fake_card(monkeypatch, blocks_per_sm=8, sms=132):
    """The wrapper's CUDA branch on CPU tensors: no device check, a fixed
    occupancy, and the C arguments of each launch recorded."""
    calls = []
    monkeypatch.setattr(_build, "on_cpu", lambda *t: False)
    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(rk, "rank_select_occupancy", lambda dev, g, v: dict(
        blocks_per_sm=blocks_per_sm, registers=32, threads=rk.THREADS,
        local_bytes=0, sms=sms, resident=blocks_per_sm * sms))
    monkeypatch.setattr(_build, "launch",
                        lambda name, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("offset, r, vec", [(0, 64, 1), (1, 64, 0),
                                            (0, 7, 0)])
def test_wrapper_passes_what_the_entry_takes(monkeypatch, offset, r, vec):
    """The C arguments up to B, the plan (group, vector loads, grid) and
    the stream: as many as the entry declares."""
    calls = _fake_card(monkeypatch)
    blocks = _blocks(r=r, offset=offset)
    q = torch.arange(16384, dtype=torch.int32) % blocks.shape[0]
    out = rk.rank_select(blocks, q, q % 23, q % (r + 1))
    ((name, args),) = calls
    assert name == "rank_select" and out.shape == (16384,)
    assert len(args) + 1 == len(_build.SIGNATURES["rank_select"])
    plan = rk.rank_select_plan(16384, r, 8 * 132)
    assert args[:2] == (blocks.data_ptr(), r)
    assert args[6:] == (16384, plan["group"], vec, plan["grid"])


def test_wrapper_launches_nothing_for_an_empty_batch(monkeypatch):
    calls = _fake_card(monkeypatch)
    e = torch.zeros(0, dtype=torch.int32)
    assert rk.rank_select(_blocks(), e, e, e).shape == (0,)
    assert calls == []


def test_wrapper_refuses_blocks_that_are_not_rows(monkeypatch):
    _fake_card(monkeypatch)
    q = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="rank_select"):
        rk.rank_select(torch.zeros(256, dtype=torch.int32), q, q, q)


def test_cpu_tensors_take_the_plain_version():
    blocks = _blocks()
    q = torch.arange(100, dtype=torch.int32) % blocks.shape[0]
    _build.reset_launches()
    assert torch.equal(rk.rank_select(blocks, q, q % 23, q % 65),
                       rk.rank_select_plain(blocks, q, q % 23, q % 65))
    assert set(_build.LAUNCHES.values()) == {0}


def _kernel_model(blocks, blk, c, cut, plan):
    """rank_select.cu's lanes in plain Python: every thread of the grid,
    its group's query (grid-stride), the two chunks a lane reads each step
    (only where a chunk's first symbol lies below the cut) and its
    symbols' count; the group's sum is lane 0's write.  Returns the
    outputs and how often each query was written."""
    G, grid, T = plan["group"], plan["grid"], rk.THREADS
    r = blocks.shape[1]
    flat = blocks.reshape(-1).tolist()
    B = len(blk)
    out, writes = [None] * B, [0] * B
    stride = grid * T // G
    for gid in range(grid * T // G):
        for q in range(gid, B, stride):
            k, base = min(cut[q], r), blk[q] * r
            total = 0
            for g in range(G):
                for j0 in range(0, k, 8 * G):
                    for j in (j0 + 4 * g, j0 + 4 * (G + g)):
                        if j < k:       # the chunk is read
                            total += sum(flat[base + i] == c[q]
                                         for i in range(j, min(j + 4, k)))
            out[q] = total
            writes[q] += 1
    return out, writes


@pytest.mark.parametrize("r", [7, 32, 64, 100, 512])
@pytest.mark.parametrize("group", rk.GROUPS)
def test_kernel_model_counts_every_symbol_below_the_cut_once(r, group):
    rng = np.random.default_rng(r + group)
    nb, B = 9, 61
    blocks = _blocks(nb=nb, r=r, sigma=5, seed=r)
    blk = rng.integers(0, nb, B)
    c = rng.integers(0, 5, B)
    cut = rng.integers(0, r + 1, B)
    cut[:3], cut[3:6] = 0, r
    plan = rk.rank_select_plan(B, r, 1, group)      # one block: grid-stride
    got, writes = _kernel_model(blocks, blk.tolist(), c.tolist(),
                                cut.tolist(), plan)
    want = rk.rank_select_plain(blocks, *(torch.from_numpy(
        x.astype(np.int32)) for x in (blk, c, cut)))
    assert got == want.tolist()
    assert writes == [1] * B


# -- the LF map of phase 7's merges (chip_smoke.py) -----------------------

_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  _ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules.setdefault("chip_smoke", mod)
    if str(_ROOT) not in sys.path:
        sys.path.append(str(_ROOT))
    spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


@pytest.mark.parametrize("kind, sig, log2n, shape, kernel", [
    ("proteins", 22, 8, (0, 1, 1, 2), "rank_select"),
    ("dna", 6, 9, (0, 1, 1, 2), "rank_packed"),
])
def test_merge_run_observes_its_lf_map(chip_smoke, kind, sig, log2n, shape,
                                       kernel):
    """A k-way merge's one LF-map rank batch: every walked row, one after
    the other, through the layout's single-batch rank kernel."""
    rec, _ = chip_smoke.merge_run(kind, sig, log2n, shape, "kway",
                                  device="cpu", latency_ns=lambda n: 0.0)
    lf = rec["lf_map"]
    assert lf["kernel"] == kernel
    assert lf["B"] == sum(rec["prepared"][1:])
    assert lf["shape"].endswith(f"B={lf['B']} consecutive rows")


@pytest.mark.parametrize("src, argtypes", [
    ("WARP_SRC", "WARP_ARGTYPES"), ("STAMPS_SRC", "STAMPS_ARGTYPES")])
def test_measurement_sources_declare_their_signatures(chip_smoke, src,
                                                      argtypes):
    """The kernel before its redesign and the stamped copies, which
    chip_smoke builds beside the kernels: each C entry takes as many
    parameters as the argument types chip_smoke passes (a file read)."""
    text = getattr(chip_smoke, src).read_text()
    for entry, types in getattr(chip_smoke, argtypes).items():
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', text)
        assert m and len(m.group(1).split(",")) == len(types)
