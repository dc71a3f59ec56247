"""The dry run on the production meshes (``repro_torch/launch/dryrun.py``
``trace_mesh_cell``): one rank's step traced on ``meta`` in a world where
no data moves (``launch/mesh.py`` ``meta_world``) against the same step in
real gloo worlds.

* A meta world's trace of a rank's train, prefill and decode step
  (``dryrun.rank_step``) gives rank 0 of a real world the same collectives
  (calls and bytes by kind and pass, ``sharding.TRAFFIC``; calls and
  input / output bytes by kind, ``dist_sort``), the same FLOPs, bytes and
  ops and the same storage peak, for reduced configs of the three
  families (dense, MLA + MoE, SSD) in worlds of ``(1, 2, 2)`` and ``(2, 2,
  2)``; every real rank counts what rank 0 counts, and the first and the
  last rank of ``(2, 2, 2)`` give equal records in the meta world.
* A meta world refuses a tensor with storage and refuses to open inside a
  world (and a real world inside it); perf's fsdp variants come back as
  per-rank 16x16 estimates, and the full-size qwen2p5_3b train cell's
  rank holds the arguments the rules give it.

The reference's per-rank argument bytes of every cell on both meshes are
held in ``test_torch_launch_specs.py``, beside the JAX reference it runs.
"""

import pytest
import torch

WORLD_TIMEOUT_S = 600
ARCHS = ("qwen2p5_3b", "deepseek_v2_236b", "mamba2_1p3b")
KINDS = {"train": "train_4k", "prefill": "prefill_32k",
         "decode": "decode_32k"}
B, S = 4, 8
MESHES = {"1x2x2": {"pod": 1, "data": 2, "model": 2},
          "2x2x2": {"pod": 2, "data": 2, "model": 2}}
GiB = 2**30


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tiny models: threads only add contention on a
    shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rules(kind: str):
    from repro_torch.sharding import DECODE_RULES, TRAIN_RULES

    return TRAIN_RULES if kind == "train" else DECODE_RULES


def _record(counts, traffic) -> dict:
    """What the meta world must reproduce of a rank's step."""
    return {"flops": dict(counts.flops_by_dtype),
            "aten_bytes": counts.aten_bytes, "peak": counts.peak_bytes,
            "ops": counts.ops, "by_pass": traffic.by_pass,
            "calls": traffic.calls, "bytes": traffic.nbytes}


def _real_inputs(cfg, kind: str, ctx) -> dict:
    """A real rank's inputs: its blocks of seeded float32 weights, zero
    moments, its cache blocks, and the global batch."""
    import numpy as np

    from repro_torch.models import transformer as tf
    from repro_torch.training.optimizer import init_opt_state

    params = tf.init_model(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu", ctx)
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(
        0, cfg.vocab_size, (B, 1 if kind == "decode" else S)
    ).astype(np.int32))
    inputs = {"params": params, "batch": {"tokens": toks}}
    if kind == "train":
        inputs["batch"]["labels"] = torch.roll(toks, -1, 1)
        inputs["opt_state"] = init_opt_state(params)
    if kind == "decode":
        inputs["cache"] = tf.init_cache(cfg, B, S, torch.bfloat16, "cpu",
                                        ctx)
    return inputs


def real_rank(mesh, cases) -> dict:
    """One rank of a gloo world: each case's step under ``roofline.count``
    (spawned: module-level)."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.sharding import world_context

    torch.set_num_threads(1)
    out = {}
    for arch, kind in cases:
        cfg = get_reduced_config(arch)
        ctx = world_context(mesh, _rules(kind))
        counts, traffic, _ = dryrun.rank_step(
            cfg, kind, ctx, _real_inputs(cfg, kind, ctx), pos=S - 1)
        out[f"{arch}|{kind}"] = _record(counts, traffic)
    return out


def _meta_rank(arch: str, kind: str, axes: dict, rank: int = 0) -> dict:
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import meta_world
    from repro_torch.sharding import world_context

    cfg = get_reduced_config(arch)
    _, _, args = dryrun.cell_inputs(cfg, KINDS[kind], rules=_rules(kind),
                                    global_batch=B, seq_len=S, mesh=axes)
    with meta_world(axes, rank) as world:
        ctx = world_context(world, _rules(kind))
        inputs = dryrun.rank_inputs(cfg, kind, ctx, args, B=B, S=S,
                                    dtype=torch.float32)
        counts, traffic, _ = dryrun.rank_step(cfg, kind, ctx, inputs,
                                              pos=S - 1)
    return _record(counts, traffic)


def _same(got, want, what: str) -> None:
    """Equal as the ranks report them (a world's results come back
    through numpy: ints as numpy ints, lists as lists)."""
    assert got.keys() == want.keys(), what
    for k, v in want.items():
        g = got[k]
        if isinstance(v, dict):
            _same(g, v, f"{what} {k}")
        elif isinstance(v, (list, tuple)):
            assert [int(x) for x in g] == [int(x) for x in v], (what, k)
        else:
            assert g == v, (what, k, g, v)


@pytest.fixture(scope="module", params=list(MESHES))
def world(request):
    from repro_torch.launch.mesh import run_world

    axes = MESHES[request.param]
    n = 1
    for size in axes.values():
        n *= size
    cases = [(a, k) for a in ARCHS for k in KINDS]
    ranks = run_world(n, real_rank, cases, mesh_shape=axes,
                      timeout_s=WORLD_TIMEOUT_S)
    return request.param, axes, ranks


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kind", list(KINDS))
def test_meta_world_counts_equal_a_real_world(world, arch, kind):
    """Rank 0's step in a meta world counts what rank 0 of the gloo world
    counted: collectives by kind and pass and their bytes, FLOPs by
    dtype, bytes, ops, the storage peak; every real rank counts the
    same."""
    name, axes, ranks = world
    want = ranks[0][f"{arch}|{kind}"]
    assert want["aten_bytes"] > 0 and want["peak"] > 0
    assert sum(int(c) for c in want["calls"].values()) > 0
    for r, rank in enumerate(ranks[1:], 1):
        _same(rank[f"{arch}|{kind}"], want, f"{name} rank {r}")
    _same(_meta_rank(arch, kind, axes), want, f"{name} meta")


@pytest.mark.parametrize("arch", ARCHS)
def test_first_and_last_rank_give_equal_records(arch):
    """In the meta world of (2, 2, 2) rank 0 and rank 7 trace the same
    cell record: rank 0 stands for every rank."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import dryrun

    cfg = get_reduced_config(arch)
    axes = MESHES["2x2x2"]
    for kind, shape in KINDS.items():
        recs = [dryrun.trace_mesh_cell(cfg, shape, axes, rank=r,
                                       global_batch=B, seq_len=S)
                for r in (0, 7)]
        for rec in recs:
            rec.pop("rank"), rec.pop("trace_s")
            for part in ("counts", "micro_batch", "update"):
                if part in rec:
                    rec[part].pop("seconds")
        assert recs[0] == recs[1], (arch, kind)
        assert recs[0]["collectives"]["moved_bytes"] > 0


def test_meta_world_refuses_real_tensors_and_nesting():
    from repro_torch.core import dist_sort as ds
    from repro_torch.launch.mesh import meta_world, single_rank_world

    with meta_world({"pod": 2, "data": 16, "model": 16}, rank=511) as w:
        info = ds.axis_info(w, "model")
        assert ds.transport(info, "meta") == \
            "meta: shapes only, no data moves"
        assert w.get_local_rank("model") == 15
        x = torch.empty(3, 5, device="meta")
        assert ds.all_gather(info, x).shape == (16, 3, 5)
        assert ds.all_gather_tiled(info, x, 1).shape == (3, 80)
        assert ds.psum(info, x).shape == (3, 5)
        assert ds.gather(info, x) is None           # not the group's root
        assert ds.argmax_sharded(info, x, 0).shape == (3,)
        for fn in (lambda t: ds.psum(info, t),
                   lambda t: ds.all_gather(info, t)):
            with pytest.raises(ValueError, match="meta tensors only"):
                fn(torch.ones(3, 5))
        with pytest.raises(RuntimeError, match="cannot open inside"):
            with meta_world({"data": 2}):
                pass
        with pytest.raises(RuntimeError, match="cannot open inside"):
            with single_rank_world("cpu"):
                pass
    with meta_world({"data": 4}, rank=0) as w:     # closed, so reopens
        info = ds.axis_info(w, "data")
        assert ds.gather(info, torch.empty(2, device="meta")).shape == (4, 2)
    with pytest.raises(ValueError, match="not one of the 4 ranks"):
        with meta_world({"data": 4}, rank=4):
            pass


def test_fsdp_variants_are_16x16_estimates(tmp_path):
    """perf's four rule-set variants return per-rank 16x16 estimates
    (estimated, 256 chips), their baselines the same mesh estimate beside
    the one-card record."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import perf

    runs = perf.qwen_train(["micro1", *perf.QWEN_MESH_VARIANTS],
                           out_dir=tmp_path, device="cpu",
                           config_of=get_reduced_config)
    assert [r["variant"] for r in runs] == ["micro1",
                                            *perf.QWEN_MESH_VARIANTS]
    for r in runs[1:]:
        assert (r["status"], r["mesh"], r["chips"]) == (
            "estimated", "16x16", 256)
        assert r["reason"] == perf.MESH_REASON
        est = r["estimate"]
        assert est["mesh"] == "16x16" and est["counts"]["flops"] > 0
        assert est["n_micro"] >= 1
    assert runs[0]["mesh_estimate"]["mesh"] == "16x16"
    by = {r["variant"]: r for r in runs}
    # v2 keeps the vocab whole: its embedding and lm_head (and their
    # moments) are whole on every rank, v3 splits them over model again
    v2 = by["fsdp_v2"]["estimate"]["argument_bytes"]["params"]
    v3 = by["fsdp_v3"]["estimate"]["argument_bytes"]["params"]
    assert v2 > v3
    assert (by["fsdp_v2_dots"]["estimate"]["argument_bytes"]
            == by["fsdp_v2"]["estimate"]["argument_bytes"])


def test_full_size_train_cell_on_the_mesh():
    """qwen2p5_3b train_4k at full size, rank 0 of 16x16: 0.486 GiB of
    arguments, 8 micro-batches of 32 x 4096 (16 data ranks), collectives
    of every kind the world step makes, a roofline with its collective
    term; fsdp_v3's rank holds 1.980 GiB."""
    from repro_torch.configs.base import get_config
    from repro_torch.launch import dryrun, perf
    from repro_torch.launch import roofline as rf

    rec = dryrun.run_cell("qwen2p5_3b", "train_4k", mesh="16x16")
    assert (rec["status"], rec["chips"], rec["rank"]) == ("traced", 256, 0)
    assert round(sum(rec["argument_bytes"].values()) / GiB, 3) == 0.486
    assert rec["n_micro"] == 8 and rec["split_axes"] == ["data", "model"]
    assert rec["counts"]["flops"] == (8 * rec["micro_batch"]["flops"]
                                      + rec["update"]["flops"])
    passes = set(rec["collectives"]["by_pass"])
    assert {"all_gather/forward", "all_gather/remat",
            "reduce_scatter/backward", "psum/forward", "psum/backward",
            "psum/grads", "psum/norm"} <= passes
    roof = rec["roofline"]
    assert roof["collective_bytes_per_device"] == \
        rec["collectives"]["moved_bytes"] > 0
    assert roof["collective_s"] == pytest.approx(
        roof["collective_bytes_per_device"] / rf.NVLINK_BW)
    assert 0 < roof["useful_flops_ratio"] <= 1
    assert rec["memory"]["fits"]
    _, _, args = dryrun.cell_inputs(get_config("qwen2p5_3b"), "train_4k",
                                    rules=perf.FSDP_V3, mesh="16x16")
    from repro_torch.launch.specs import local_nbytes

    assert round(sum(local_nbytes(a) for a in args.values()) / GiB, 3) \
        == 1.980
