"""The bwt_index cells on the production meshes
(``repro_torch/launch/dryrun.py`` ``trace_index_mesh_cell``): one rank of
the distributed index's build (the ISA) and serve (``dist_count``) traced
on ``meta`` in a world where no data moves, against real gloo worlds.

* Every round is the same program: in gloo worlds of 2 and 4, english
  and dna texts of 2^12 tokens, the ISA the early-exit loop returns is
  left bit for bit as it is by every round of the budget after it, and
  is the inverse of the JAX package's suffix array of the same text
  (``test_torch_dist_sa.py``'s ``_jax_build``).  A rank traced on meta
  runs those rounds.
* A meta rank is a real rank: for both cells in worlds of 2 and 4, the
  meta world's rank 0 records the collectives (calls, input and output
  bytes by kind) that every rank of a gloo world records running the
  every-round program on CPU tensors.
* The kernel wrappers on ``meta``: each returns the plain version's shape
  and dtype and reports the bytes its reckoning gives for those shapes,
  launching nothing; a ``meta`` tensor reaches no collective of a real
  group.
* The four mesh cells of ``dryrun --arch bwt_index --multi-pod both`` at
  n = 2^16 (each shard whole: m at least the Occ sample rate), with the
  per-rank bytes the config's arithmetic gives.

The reference's per-rank argument bytes at the config's n = 2^28 are held
in ``test_torch_launch_specs.py``, beside the JAX reference it runs.
"""

import numpy as np
import pytest
import torch

from test_torch_dist_sa import _jax_build

WORLDS = (2, 4)
N = 1 << 12
MESH_N = 1 << 16
WORLD_TIMEOUT_S = 300
KINDS = ("english", "dna")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (small shapes: threads only add contention on
    a shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _icfg(n: int = N):
    from repro_torch.configs.bwt_index import CONFIG

    return CONFIG.replace(n=n, query_batch=16, query_len=8)


def _text(kind: str, P: int):
    """A corpus text prepared as ``build_index`` prepares it for ``P``
    ranks (``N`` tokens with its sentinel and pads) and its sigma."""
    from repro_torch.configs.bwt_index import CONFIG
    from repro_torch.core.pipeline import prepare_tokens
    from repro_torch.data.corpus import corpus

    return prepare_tokens(corpus(kind, N - 1), P * 64,
                          CONFIG.sigma if kind == "english" else None)


def _every_round(info, cfg, s_local, sigma):
    """The ISA by the early-exit loop's rounds, then every round left in
    the budget: (ISA at the loop's exit, rounds run to it, ISA after the
    budget, rounds in the budget)."""
    from repro_torch.core import keypack
    from repro_torch.core.dist_suffix_array import (
        _doubling_round,
        _gidx,
        isa_init,
        num_rounds,
    )
    from repro_torch.core.suffix_array import resolve_local_sort

    eng = resolve_local_sort(cfg.local_sort, s_local.device)
    rank, active, h0, done, _ = isa_init(info, cfg, eng, s_local, sigma)
    gidx = _gidx(info, s_local.device)
    spec = keypack.pair_spec(info.n)
    rounds = cfg.rounds if cfg.rounds is not None else num_rounds(info.n, h0)
    exit_isa, run = None, rounds
    for r in range(rounds):
        if exit_isa is None and bool(done):
            exit_isa, run = rank.clone(), r
        rank, active, done, _ = _doubling_round(
            info, cfg, eng, spec, h0 * 2 ** r, rank, gidx, active)
    return (rank if exit_isa is None else exit_isa), run, rank, rounds


def _collectives() -> dict:
    from repro_torch.core import dist_sort

    return {"calls": {k: v for k, v in dist_sort.COLLECTIVES.items() if v},
            "bytes": {k: list(v) for k, v in
                      dist_sort.COLLECTIVE_BYTES.items()
                      if dist_sort.COLLECTIVES[k]}}


def world_rank(mesh) -> dict:
    """One rank of a gloo world (spawned: module-level): each text's ISA
    by the early-exit loop and by the every-round program, and each
    cell's collectives on CPU tensors as the meta rank traces it."""
    from repro_torch.core import dist_sort
    from repro_torch.core.dist_fm import build_dist_fm_index, dist_count
    from repro_torch.core.dist_suffix_array import (
        dist_bwt_local,
        dist_isa_local,
        local_text,
    )
    from repro_torch.core.pipeline import mesh_sa_config
    from repro_torch.data.corpus import corpus
    from repro_torch.launch import dryrun

    P = dist_sort.mesh_parts(mesh)
    out = {}
    cfg = mesh_sa_config(_icfg())
    for kind in KINDS:
        s, sigma = _text(kind, P)
        info, s_local = local_text(s, mesh, device="cpu")
        early = dist_isa_local(info, cfg, s_local, sigma)
        exit_isa, run, every, rounds = _every_round(info, cfg, s_local,
                                                    sigma)
        out[kind] = dict(early=early, exit=exit_isa, every=every, run=run,
                         rounds=rounds)
    # the cells' own programs on real tensors: the config's n and sigma
    icfg = _icfg()
    s = np.append(corpus("english", icfg.n - 1), 0).astype(np.int32)
    info, s_local = local_text(s, mesh, device="cpu")
    dist_sort.reset_collectives()
    *_, isa, _ = _every_round(info, dryrun.index_sa_config(icfg), s_local,
                              icfg.sigma)
    out["build"] = _collectives()
    _, bwt, row = dist_bwt_local(info, cfg, s_local, isa)
    index = build_dist_fm_index(bwt, row, mesh, sigma=icfg.sigma,
                                sample_rate=icfg.sample_rate, pack=False)
    pats = torch.as_tensor(dryrun.index_patterns(
        s[:-1], icfg.query_batch, icfg.query_len))
    dist_sort.reset_collectives()
    out["hits"] = dist_count(index, pats, mesh)
    out["serve"] = _collectives()
    return out


@pytest.fixture(scope="module")
def worlds():
    from repro_torch.launch.mesh import run_world

    return {P: run_world(P, world_rank, timeout_s=WORLD_TIMEOUT_S)
            for P in WORLDS}


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("P", WORLDS)
def test_every_round_is_the_same_program(worlds, P, kind):
    s, _ = _text(kind, P)
    sa, _, _ = _jax_build(s)
    ranks = worlds[P]
    got = {k: np.concatenate([r[kind][k] for r in ranks])
           for k in ("early", "exit", "every")}
    assert np.array_equal(got["early"], got["exit"])
    assert np.array_equal(got["every"], got["exit"])
    assert np.array_equal(got["every"][sa], np.arange(len(s)))
    run, rounds = ranks[0][kind]["run"], ranks[0][kind]["rounds"]
    assert {(r[kind]["run"], r[kind]["rounds"]) for r in ranks} == {
        (run, rounds)}
    assert run < rounds          # the budget ran rounds past the exit


@pytest.mark.parametrize("shape", ["build", "serve"])
@pytest.mark.parametrize("P", WORLDS)
def test_meta_rank_collectives_equal_a_real_world(worlds, P, shape):
    """The meta world's rank 0 records every real rank's collectives; the
    serve cell's are two psums of the batch a pattern position."""
    from repro_torch.launch import dryrun

    icfg = _icfg()
    rec = dryrun.trace_index_mesh_cell(shape, P, icfg)
    want = {"calls": rec["collectives"]["calls"],
            "bytes": rec["collectives"]["bytes"]}
    for r in worlds[P]:
        assert r[shape] == want, (P, shape)
    if shape == "serve":
        assert want["calls"] == {"psum": 2 * icfg.query_len}
        assert min(r["hits"].min() for r in worlds[P]) >= 1
    else:
        assert rec["rounds_traced"] == worlds[P][0]["english"]["rounds"]


def _recorded(fn, *args, **kwargs):
    """``fn``'s result and the bytes its wrapper reported, with the launch
    counts read around it."""
    from repro_torch.kernels import _build, traffic

    class Sink:
        def __init__(self):
            self.seen = []

        def kernel_bytes(self, name, nbytes):
            self.seen.append((name, nbytes))

    before = dict(_build.LAUNCHES)
    with traffic.recording(Sink()) as sink:
        out = fn(*args, **kwargs)
    assert _build.LAUNCHES == before
    return out, sink.seen


def _wrapper_calls(device):
    """Each wrapper's call on tensors of ``device``: (name, fn, args, kw);
    the rank queries read whole blocks (``traffic.whole_blocks``)."""
    from repro_torch.kernels import (
        char_histogram,
        radix_hist,
        radix_sort,
        rank_select,
        rerank_scan,
        traffic,
    )

    g = torch.Generator().manual_seed(0)

    def ints(*shape, hi=1 << 20):
        return torch.randint(0, hi, shape, generator=g,
                             dtype=torch.int32).to(device)

    n, block, nb, r, B, sigma = 2048, 1024, 48, 64, 80, 257
    keys = ints(n)
    base = radix_sort.digit_major_bases(radix_hist.radix_hist_plain(
        keys.cpu(), 8, block=block)).to(device)
    ops, outs = (keys, ints(n)), (ints(n), ints(n))
    blk, c, cut = (t.to(device) for t in traffic.whole_blocks(nb, r, B))
    fused = ints(nb, 5 + 8)
    blkp, cp, cutp = (t.to(device) for t in traffic.whole_blocks(
        nb, 8 * 8, B))
    return [
        ("radix_hist", radix_hist.radix_hist, (keys, 8), {"block": block}),
        ("radix_pos", radix_sort.radix_pos, (keys, base, 8),
         {"block": block}),
        ("radix_scatter", radix_sort.radix_scatter,
         (keys, base, 8, ops, outs), {"block": block}),
        ("rank_select", rank_select.rank_select,
         (ints(nb, r, hi=sigma), blk, c, cut), {}),
        ("rank_packed", rank_select.rank_packed,
         (fused, blkp, cp, cutp), {"bits": 4, "sigma": 5}),
        ("char_histogram", char_histogram.char_histogram,
         (ints(n, hi=sigma), sigma), {}),
        ("rerank_scan", rerank_scan.rerank_scan, (keys, ints(n)), {}),
    ]


def _meta(x, memo=None):
    """``x`` with each tensor replaced by a ``meta`` tensor of its shape
    and dtype (one for each distinct tensor: an operand that is also the
    keys stays so)."""
    memo = {} if memo is None else memo
    if isinstance(x, torch.Tensor):
        if id(x) not in memo:
            memo[id(x)] = torch.empty(x.shape, dtype=x.dtype, device="meta")
        return memo[id(x)]
    if isinstance(x, tuple):
        return tuple(_meta(v, memo) for v in x)
    return x


@pytest.mark.parametrize("name", [c[0] for c in _wrapper_calls("cpu")])
def test_wrappers_take_meta_tensors(name):
    """On ``meta`` a wrapper's result has the plain version's shape and
    dtype, it reports the bytes the plain call reports on the same
    shapes, and it launches nothing."""
    cpu = {c[0]: c[1:] for c in _wrapper_calls("cpu")}[name]
    fn, args, kw = cpu
    want, want_bytes = _recorded(fn, *args, **kw)
    got, got_bytes = _recorded(fn, *_meta(args), **kw)
    assert got_bytes == want_bytes and want_bytes[0][1] > 0
    for a, b in zip(*(x if isinstance(x, tuple) else (x,)
                      for x in (got, want))):
        if isinstance(b, torch.Tensor):
            assert a.device.type == "meta"
            assert (a.shape, a.dtype) == (b.shape, b.dtype)
        else:
            assert a is b is None


def test_rank_bytes_on_meta_bound_a_batch():
    """The rank kernels' meta reckoning (whole blocks) is the most a batch
    of those shapes reads: random queries report no more."""
    from repro_torch.kernels import traffic

    g = torch.Generator().manual_seed(1)
    blocks = torch.zeros(48, 64, dtype=torch.int32)
    for B in (7, 48, 200):
        blk = torch.randint(0, 48, (B,), generator=g, dtype=torch.int32)
        cut = torch.randint(0, 65, (B,), generator=g, dtype=torch.int32)
        meta = torch.empty(B, dtype=torch.int32, device="meta")
        bound = traffic.rank_select_bytes(_meta(blocks), meta, meta)
        assert traffic.rank_select_bytes(blocks, blk, cut) <= bound
        assert bound == min(B, 48) * 64 * 4 + 16 * B


def test_meta_tensors_reach_no_real_collective():
    """A ``meta`` tensor in a real (gloo) group is refused at the
    collective, and a CUDA-bound check still refuses it outside a
    wrapper's meta branch."""
    from repro_torch.core import dist_sort
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import single_rank_world

    with single_rank_world("cpu") as mesh:
        info = dist_sort.shard_info(mesh, 1)
        with pytest.raises(ValueError, match="only a meta world takes it"):
            dist_sort.psum(info, torch.empty(1, dtype=torch.int32,
                                             device="meta"))
        assert int(dist_sort.psum(info, torch.ones(1, dtype=torch.int32))
                   ) == 1
    meta = torch.empty(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        _build.check_cuda("radix_hist", meta)
    assert _build.traced("radix_hist", meta)
    assert not _build.on_cpu(meta) and not _build.on_meta(
        meta, torch.empty(4, dtype=torch.int32))


def test_four_mesh_cells_at_a_small_n(tmp_path):
    """``dryrun --arch bwt_index --multi-pod both`` at n = 2^16: four
    traced records in the reference's order, each fitting, moving
    collective bytes and counting its kernels' bytes, with the per-rank
    sizes the config's arithmetic gives (m = n / P a rank, buckets of
    ceil(2 m / P), 14 rounds after the q = 6 init)."""
    from repro_torch.launch import dryrun

    icfg = _icfg(MESH_N)
    recs = dryrun.main(["--arch", "bwt_index", "--multi-pod", "both",
                        "--out", str(tmp_path)], index_cfg=icfg)
    assert [(r["shape"], r["mesh"], r["status"]) for r in recs] == [
        (s, m, "traced") for s in ("build", "serve")
        for m in ("16x16", "2x16x16")]
    assert len(list(tmp_path.glob("bwt_index__*.json"))) == 4
    for r in recs:
        P = {"16x16": 256, "2x16x16": 512}[r["mesh"]]
        m = MESH_N // P
        assert (r["chips"], r["part_size"]) == (P, m)
        assert r["memory"]["fits"]
        assert r["collectives"]["moved_bytes"] > 0
        assert r["roofline"]["collective_s"] > 0
        kb = r["counts"]["kernel_bytes"]
        if r["shape"] == "build":
            assert r["argument_bytes"] == r["held_argument_bytes"] == {
                "s": 4 * m}
            assert kb["radix_hist"] > 0 and kb["radix_pos"] > 0
            assert r["bucket_capacity"] == -(-2 * m // P)
            assert (r["h0"], r["rounds_traced"]) == (6, 14)
            assert r["local_sort"] == "radix"
        else:
            B, L = icfg.query_batch, icfg.query_len
            assert r["argument_bytes"] == {
                "bwt": 4 * m, "occ_samples": m // 64 * 257 * 4,
                "c_array": 257 * 4, "fused": 4, "patterns": 4 * B * L}
            assert r["held_argument_bytes"]["row"] == 4
            assert kb["rank_select"] > 0
            assert r["collectives"]["calls"] == {"psum": 2 * L}
            assert r["collectives"]["moved_bytes"] == 2 * L * 2 * 4 * B
