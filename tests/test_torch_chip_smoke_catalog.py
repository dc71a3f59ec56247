"""chip_smoke.py's phase 8 (the segmented catalog) helpers rehearsed on
the CPU: the buckets' byte arithmetic, the stacked bounds and latency
floors by hand, the kernel before its redesign, the cut views, the edge
cases, the kernels line, and the phase itself at a tiny size.  No GPU.
(Moved from ``test_torch_chip_smoke.py``, whose one worker ran them all.)
"""

import types

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


# -- phase 8: the segmented catalog --------------------------------------

def test_bucket_bytes_at_the_catalog_scale():
    """Phase 8's buckets: DNA 2^28 in 16 segments (2^18 + 1 blocks each,
    15-word fused rows at r = 64, SA stride 32) is 0.50 GB of rows and
    0.20 GB of SA sample; a 17th segment doubles it (1.4 GB); proteins
    2^24 in 4 segments (r + sigma = 87 words per block)."""
    dna = chip_smoke.bucket_bytes(16, (1 << 18) + 1, 15, 64, 32)
    assert dna == {"seg_pad": 16, "blocks_pad": 1 << 19,
                   "rows": 503_316_480, "sa_sample": 201_326_592}
    grown = chip_smoke.bucket_bytes(17, (1 << 18) + 1, 15, 64, 32)
    assert grown["seg_pad"] == 32
    assert grown["rows"] + grown["sa_sample"] == 1_409_286_144
    assert chip_smoke.bucket_bytes(4, (1 << 16) + 1, 64 + 23, 64, 32) == {
        "seg_pad": 4, "blocks_pad": 1 << 17, "rows": 182_452_224,
        "sa_sample": 12_582_912}


def _small_catalog(pack, n_seg=3, seg_pad=None, compress_sa=False):
    import torch  # noqa: F401

    from repro_torch.core.fm_index import stack_fm_indexes
    from repro_torch.core.pipeline import build_index
    from repro_torch.data.corpus import corpus

    fms = [build_index(corpus("dna", 300 + 70 * i, seed=i), sample_rate=16,
                       sa_sample_rate=8, sigma=6, pack=pack,
                       compress_sa=compress_sa, device="cpu").fm
           for i in range(n_seg)]
    return fms, stack_fm_indexes(fms, seg_pad=seg_pad)


@pytest.mark.parametrize("pack", [None, False])
def test_built_bucket_matches_its_arithmetic(pack):
    fms, st = _small_catalog(pack)
    row_words = st.fused.shape[1] if st.bits else 16 + st.sigma
    assert chip_smoke.stacked_bucket_bytes(st) == chip_smoke.bucket_bytes(
        3, max(f.n_blocks for f in fms), row_words, 16, 8)


@pytest.mark.parametrize("pack", [None, False])
def test_stacked_bound_sums_the_segments(pack):
    """The stacked kernel's bytes bound over n_seg x B lanes: each
    segment's own bytes (``query_bytes`` of its view, equal to its index's
    with raw SA values), the patterns once, pad rows' outputs; its walk is
    the longest segment's."""
    from repro_torch.data.corpus import corpus

    fms, st = _small_catalog(pack, seg_pad=4)
    toks = corpus("dna", 300, seed=0)
    P = chip_smoke.pad_patterns(chip_smoke.sample_patterns(toks, 40, 1),
                                32, "cpu")
    for k in (0, 4):
        per = [chip_smoke.query_bytes(f, P, k) for f in fms]
        views = [chip_smoke.query_bytes(chip_smoke.segment_view(st, s), P, k)
                 for s in range(3)]
        assert views == per
        B = P.shape[0]
        want = (sum(b for b, _ in per) - 2 * 4 * P.numel()
                + 4 * (2 * B + B * k))
        assert chip_smoke.stacked_query_bytes(st, P, k) == (
            want, max(w for _, w in per))


def test_phase_catalog_runs_on_the_cpu():
    """Phase 8 at a tiny size on the CPU (plain versions, no launch): the
    catalog's checks pass (the 2-bit catalog's too), segment_min_tokens shrinks with the corpus, the
    growth compacts and the save -> load and second save pass; every
    bucket's edge cases (k = 0, 1, 16, 64) and n_seg views up to its own
    were held to the plain version; the card's records (the kernels-line
    rows, the 16-segment proteins sweep) are empty here."""
    from repro_torch.data.corpus import corpus

    rec, launches, rows = chip_smoke.phase_catalog(
        corpus("dna", 1 << 13), 11, 9, device="cpu", requests=32)
    dna, prot = rec["dna"], rec["proteins"]
    assert dna["segments"] == 16 and prot["segments"] == 4
    assert dna["bits"] == 4 and prot["bits"] == 0
    assert dna["max_abs_err"] == prot["max_abs_err"] == 0
    two_bit = rec["two_bit"]
    assert two_bit["bits"] == 2 and two_bit["max_abs_err"] == 0
    assert two_bit["seg_pad"] > two_bit["segments"]
    assert dna["growth"]["merges"] >= 1
    assert dna["forced_kway"]["fm_mismatch"] == []
    assert dna["save_load"]["second_save_files"] >= 1
    assert all(set(v.values()) == {0} for v in launches.values())
    assert rows == {"fm_query_stacked_packed": None,
                    "fm_query_stacked_unpacked": None}
    edge = ["edge k=0", "edge k=1", "edge k=16", "edge k=64"]
    for r, views in ((dna, [1, 2, 4, 8, 16]), (prot, [1, 2, 4]),
                     (two_bit, [1, 2, 4])):
        assert r["edge_cases"] == edge and r["views"] == views
    assert dna["row"] is None and "sweep" not in dna
    assert rec["proteins_16_segments"] is None


@pytest.mark.parametrize("pack", [None, False])
def test_latency_floor_by_hand(pack):
    """The longest pattern's symbols (PADs load nothing), then the walk's
    steps (one round trip a step packed, two unpacked) and the value, at
    the chase's latency over the bucket's row words."""
    import torch

    fms, st = _small_catalog(pack)
    P = torch.full((3, 8), -1, dtype=torch.int32)
    P[0, :5] = 1
    P[1, :7] = 2                       # the longest: 7 search steps
    P[2, :2] = 3
    seen = []

    def ns(words):
        seen.append(words)
        return 250.0

    floor = chip_smoke.latency_floor(st, P, 4, ns)
    per_step = 1 if st.bits else 2
    words = (st.fused.numel() if st.bits
             else st.blocks.numel() + st.occ.numel())
    assert seen == [words]
    assert floor["dependent_loads"] == 7 + 4 * per_step + 1
    assert floor["latency_floor_ms"] == pytest.approx(
        (7 + 4 * per_step + 1) * 250.0 / 1e6)
    count = chip_smoke.latency_floor(st, P, 0, ns)   # count: no walk
    assert count["dependent_loads"] == 7


def test_pre_redesign_launch_geometry_by_hand():
    """The replaced kernel's grid: 128-thread blocks over B x max(k, 1)
    lanes (packed) or B x 16 per 16 slots (unpacked), times seg_pad; waves
    over the card's resident blocks."""
    import types

    packed = types.SimpleNamespace(bits=4, seg_pad=16)
    unpacked = types.SimpleNamespace(bits=0, seg_pad=4)
    assert chip_smoke.lanes_blocks(packed, 1024, 16) == 2048
    assert chip_smoke.lanes_blocks(packed, 1024, 0) == 128
    assert chip_smoke.lanes_blocks(packed, 64, 16) == 128
    assert chip_smoke.lanes_blocks(unpacked, 1024, 16) == 512
    assert chip_smoke.lanes_blocks(unpacked, 1024, 17) == 1024
    assert chip_smoke.lanes_blocks(unpacked, 1024, 0) == 512
    assert chip_smoke.waves(2048, 10, 132) == pytest.approx(1.5515, 1e-4)


def test_pre_redesign_source_declares_its_signatures():
    """The pre-redesign kernel's C entries take as many parameters as the
    argument types chip_smoke passes (a file read, no nvcc)."""
    import re

    src = chip_smoke.LANES_SRC.read_text()
    for entry, types_ in chip_smoke.LANES_ARGTYPES.items():
        m = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        assert m and len(m.group(1).split(",")) == len(types_), entry


def test_check_views_refuses_a_wrong_row(monkeypatch):
    """A kernel whose row of a real segment of a cut view differs from
    the plain version's fails; rows past the cut are not compared."""
    import torch

    fms, st = _small_catalog(None, seg_pad=4)
    P = torch.tensor([[1, 2, -1], [3, 1, -1]], dtype=torch.int32)
    name, kern, plain = chip_smoke.stacked_fns(st)

    def past_the_cut(v, P, k):
        sp, ep, pos = plain(v, P, k)
        sp = sp.clone()
        sp[v.n_seg:] += 1              # rows of pad segments: not compared
        return sp, ep, pos

    monkeypatch.setattr(chip_smoke, "stacked_fns",
                        lambda st: (name, past_the_cut, plain))
    assert chip_smoke.check_views(st, P, 2) == [1, 2]

    def wrong(v, P, k):
        sp, ep, pos = plain(v, P, k)
        return sp, ep + (v.n_seg == 2), pos

    monkeypatch.setattr(chip_smoke, "stacked_fns",
                        lambda st: (name, wrong, plain))
    with pytest.raises(AssertionError, match="n_seg=2 ep"):
        chip_smoke.check_views(st, P, 2)


def test_edge_cases_aim_at_the_walk_list():
    """All-PAD, every length-1 pattern, out-of-alphabet symbols and a cut
    from inside the second segment, padded to 128, at k = 0, 1, 16, 64."""
    import numpy as np
    import torch

    fms, st = _small_catalog(None)
    toks = [np.arange(1, 301, dtype=np.int32) % 5 + 1 for _ in range(3)]
    cases = chip_smoke.stacked_edge_cases(st, toks)
    assert [k for _, _, k in cases] == [0, 1, 16, 64]
    E = cases[0][1]
    assert E.shape[1] == 128 and bool((E[0] == -1).all())
    cut = torch.as_tensor(toks[1][150:190])
    assert any(bool((row[:40] == cut).all()) for row in E)


def test_kernels_line_lists_every_kernel_with_every_key():
    from repro_torch.kernels import _build

    rows = {name: dict(max_abs_err=0, ms=1.0, plain_ms=2.0, bound_ms=0.5,
                       library_ms=None, device_ms=0.9, shape="s")
            for name in _build.KERNELS}
    rows["fm_query_stacked_packed"]["dependent_steps"] = {"search": 32,
                                                         "walk": 32}
    launches = {name: 1 for name in _build.KERNELS}
    line = chip_smoke.kernels_line(rows, launches, {"catalog_dna": launches})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [k["name"] for k in line["kernels"]] == list(_build.KERNELS)
    for entry in line["kernels"]:
        assert keys <= set(entry)
        assert (chip_smoke.ROOT / entry["source"]).is_file()
        assert entry["replaces"].startswith("src/repro/kernels/")
    stacked = {k["name"]: k for k in line["kernels"]
               if "stacked" in k["name"]}
    assert {k["source"] for k in stacked.values()} == {
        "src/repro_torch/kernels/csrc/fm_query_stacked.cu"}
    assert stacked["fm_query_stacked_packed"]["dependent_steps"] == {
        "search": 32, "walk": 32}
