"""The stacked query kernels' host side (``kernels/fm_query.py``): the
packed entry's tile plan and grid against hand values, and the C
arguments each wrapper passes against the argument types it declares and
the parameters of the entries in ``csrc/fm_query_stacked.cu`` (a file
read, no nvcc).  The kernels' answers are held to the JAX package in
``test_torch_stacked.py`` (CPU: their plain versions) and to their plain
versions on the card by chip_smoke.py phase 8.
"""

import re

import pytest
import torch

from repro_torch.core.fm_index import stack_fm_indexes
from repro_torch.core.pipeline import build_index
from repro_torch.data.corpus import corpus
from repro_torch.kernels import _build
from repro_torch.kernels import fm_query as fq


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the shapes here are small, and torch's thread
    pool only adds synchronisation when the host's cores are shared with
    the suite's other workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("B, n_seg, resident, tile", [
    (1024, 16, 1320, 13),    # 16 x 79 = 1264 blocks; 12 would take 1376
    (64, 16, 1320, 1),       # a pair a block already fits
    (1024, 4, 1320, 4),      # 4 x 256 = 1024; 3 would take 1368
    (1024, 32, 1320, 25),    # 32 x 41 = 1312
    (1000, 3, 30, 100),      # 3 x 10 = 30 exactly
    (8192, 64, 1320, 128),   # none fits: a lane a pair, a full block
    (1, 1, 1, 1),
])
def test_plan_by_hand(B, n_seg, resident, tile):
    assert fq.stacked_plan(B, n_seg, resident) == tile


def test_plan_is_the_fewest_pairs_in_one_wave():
    for B in (1, 7, 64, 100, 1024, 4096):
        for n_seg in (1, 3, 16, 33):
            for resident in (1, 132, 1320, 2640):
                tile = fq.stacked_plan(B, n_seg, resident)
                fits = n_seg * -(-B // tile) <= resident
                assert 1 <= tile <= fq.STACKED_THREADS
                assert fits or tile == fq.STACKED_THREADS
                if fits and tile > 1:
                    assert n_seg * -(-B // (tile - 1)) > resident


@pytest.mark.parametrize("B, seg_pad, tile, blocks", [
    (1024, 16, 13, 1264), (64, 16, 1, 1024), (1000, 4, 8, 500),
    (5, 8, 8, 8), (1024, 32, 128, 256)])
def test_grid_by_hand(B, seg_pad, tile, blocks):
    assert fq.stacked_grid(B, seg_pad, tile) == blocks


def _c_params(entry: str) -> int:
    src = (_build.CSRC / "fm_query_stacked.cu").read_text()
    m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
    assert m, entry
    return len(m.group(1).split(","))


@pytest.mark.parametrize("name", ["fm_query_stacked_packed",
                                  "fm_query_stacked_unpacked"])
def test_declared_argument_types_match_the_source(name):
    assert len(_build.SIGNATURES[name]) == _c_params(f"{name}_launch")


def test_occupancy_query_matches_the_source():
    assert len(fq.OCCUPANCY_ARGTYPES) == _c_params(
        "fm_query_stacked_occupancy")


def _bucket(pack):
    fms = [build_index(corpus("dna", 400 + 90 * i, seed=i), sample_rate=16,
                       sa_sample_rate=8, sigma=6, pack=pack,
                       device="cpu").fm for i in range(3)]
    return stack_fm_indexes(fms, seg_pad=4)


@pytest.mark.parametrize("pack, k", [(None, 0), (None, 4), (False, 0),
                                     (False, 4)])
def test_wrapper_passes_what_the_entry_takes(monkeypatch, pack, k):
    """The C arguments up to k, the packed entry's tile, the three
    outputs and the stream: as many as the entry declares; the outputs
    [S, B] / [S, B, k]."""
    st = _bucket(pack)
    name = "fm_query_stacked_packed" if st.bits else \
        "fm_query_stacked_unpacked"
    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    P = torch.full((5, 7), -1, dtype=torch.int32)
    out, args = fq.stacked_launch_args(name, st, P, k)
    assert len(args) + bool(st.bits) + len(out) + 1 == len(
        _build.SIGNATURES[name])
    assert [tuple(t.shape) for t in out] == [(4, 5), (4, 5), (4, 5, k)]
    assert args[-4:] == (P.data_ptr(), 5, 7, k)


@pytest.mark.parametrize("pack", [None, False])
def test_cpu_tensors_take_the_plain_version(pack):
    st = _bucket(pack)
    kern, plain = ((fq.fm_query_stacked_packed,
                    fq.fm_query_stacked_packed_plain) if st.bits else
                   (fq.fm_query_stacked_unpacked,
                    fq.fm_query_stacked_unpacked_plain))
    P = torch.tensor([[1, 2, -1], [3, -1, -1], [-1, -1, -1]],
                     dtype=torch.int32)
    _build.reset_launches()
    for got, want in zip(kern(st, P, 4), plain(st, P, 4)):
        assert torch.equal(got, want)
    assert set(_build.LAUNCHES.values()) == {0}


def test_launch_arguments_refuse_cpu_tensors():
    st = _bucket(None)
    P = torch.full((2, 3), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        fq.stacked_launch_args("fm_query_stacked_packed", st, P, 2)
