"""The port's roofline (``repro_torch/launch/roofline.py``): the collective
byte model against the JAX package's on HLO lines built from the same
records, the terms and bottleneck, ``model_flops`` for the ten configs,
and ``count``: a step traced on ``meta`` counts what the same step counts
on the CPU, train FLOPs under remat "full" equal ``chip_smoke.train_flops``,
counts grow linearly with the stacked groups, the live-storage peak of a
toy chain, and the bytes each kernel wrapper reports beside what its plain
version moves.  The LM's abstract helpers take ``meta``; the index entry
points refuse it.
"""

import importlib.util
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.launch import roofline as rf

_ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread (tiny models: threads only add contention on a
    shared host)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _chip_smoke():
    if "chip_smoke" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke", _ROOT / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules["chip_smoke"] = mod
        spec.loader.exec_module(mod)
    return sys.modules["chip_smoke"]


# --------------------------------------------------------------------------
# the byte model and the terms
# --------------------------------------------------------------------------

# (port kind, HLO line of the same shapes): tests/test_roofline.py's
RECORDS = [
    ("all_gather", 16 * 4096 * 128 * 2, 16 * 4096 * 2048 * 2,
     "%ag = bf16[16,4096,2048]{2,1,0} all-gather(bf16[16,4096,128]{2,1,0} "
     "%p0), dimensions={2}"),
    ("psum", 1024 * 1024 * 4, 1024 * 1024 * 4,
     "%ar = f32[1024,1024]{1,0} all-reduce(f32[1024,1024]{1,0} %x), "
     "to_apply=%add"),
    ("pmax", 64 * 4, 64 * 4,
     "%am = s32[64]{0} all-reduce(s32[64]{0} %m), to_apply=%max"),
    ("all_to_all", 4096 * 4, 4096 * 4,
     "%a2a = s32[4096]{0} all-to-all(s32[4096]{0} %z)"),
    ("ppermute", 512 * 512 * 2, 512 * 512 * 2,
     "%cp = bf16[512,512]{1,0} collective-permute(bf16[512,512]{1,0} %w), "
     "source_target_pairs={{0,1}}"),
]


def test_collective_bytes_equal_the_reference_model():
    from repro.launch.roofline import collective_bytes as ref_bytes

    hlo = "\n".join(line for *_, line in RECORDS)
    want = ref_bytes(hlo)
    got = rf.collective_bytes([(k, 1, i, o) for k, i, o, _ in RECORDS])
    assert got.counts == want.counts
    assert got.bytes_by_op == want.bytes_by_op
    assert got.total_bytes == want.total_bytes
    # many calls of a kind in one record: the terms are linear
    twice = rf.collective_bytes([(k, 2, 2 * i, 2 * o)
                                 for k, i, o, _ in RECORDS])
    assert twice.bytes_by_op == {k: 2 * v for k, v in want.bytes_by_op.items()}


def test_gather_moves_the_root_its_peers_shards():
    got = rf.collective_bytes([("gather", 1, 100, 400), ("gather", 1, 100, 0)])
    assert got.bytes_by_op == {"gather": 300 + 100}
    assert rf.collective_bytes([("psum", 0, 0, 0)]).counts == {}
    with pytest.raises(ValueError, match="unknown collective"):
        rf.collective_bytes([("broadcast", 1, 4, 4)])


def test_roofline_terms_and_bottleneck():
    r = rf.Roofline(
        flops_per_device=rf.PEAK_FLOPS["bf16"],          # 1 s compute
        bytes_per_device=rf.HBM_BW / 2,                  # 0.5 s memory
        collective_bytes_per_device=rf.NVLINK_BW * 2,    # 2 s collective
        collective_detail={}, chips=1)
    assert np.isclose(r.compute_s, 1.0)
    assert np.isclose(r.memory_s, 0.5)
    assert np.isclose(r.collective_s, 2.0)
    assert r.bottleneck == "collective"
    assert np.isclose(r.step_time_s, 2.0)
    f32 = rf.Roofline(rf.PEAK_FLOPS["float32"], 0.0, 0.0, {}, 1, "float32")
    assert np.isclose(f32.compute_s, 1.0) and f32.bottleneck == "compute"
    d = f32.to_dict()
    assert d["dtype"] == "float32" and d["chips"] == 1
    assert set(d) >= {"flops_per_device", "bytes_per_device",
                      "collective_bytes_per_device", "collective_detail",
                      "compute_s", "memory_s", "collective_s", "bottleneck",
                      "step_time_s"}


def test_model_flops_equal_the_reference():
    from repro.configs.base import get_config as ref_config
    from repro.launch.roofline import model_flops as ref_model_flops

    from repro_torch.configs.base import ARCH_IDS, get_config

    for arch in ARCH_IDS:
        if arch == "bwt_index":
            continue
        for tokens in (1, 256 * 4096):
            assert rf.model_flops(get_config(arch), tokens) == \
                ref_model_flops(ref_config(arch), tokens), arch


# --------------------------------------------------------------------------
# counting
# --------------------------------------------------------------------------

def _inputs(cfg, kind: str, device: str, B: int = 2, S: int = 32):
    from repro_torch.models import transformer as tf

    params = tf.init_model(cfg, torch.Generator().manual_seed(0),
                           torch.float32, "cpu")
    if device == "meta":
        params = tf.tree_map(lambda t: torch.empty_like(t, device="meta"),
                             params)
    toks = torch.zeros((B, 1 if kind == "decode" else S), dtype=torch.int32,
                       device=device)
    if kind == "decode":
        cache = tf.init_cache(cfg, B, S, torch.float32, device=device)
        return params, cache, toks, S - 1
    batch = {"tokens": toks, "labels": toks} if kind == "train" else {
        "tokens": toks}
    if cfg.frontend != "none":
        batch.pop("tokens")
        batch["embeds"] = torch.zeros((B, S, cfg.d_model), device=device)
    return params, batch


@pytest.mark.parametrize("arch,kind", [
    ("qwen2p5_3b", "train"), ("deepseek_v2_236b", "train"),
    ("mamba2_1p3b", "train"), ("recurrentgemma_2b", "prefill"),
    ("minicpm3_4b", "decode"), ("llava_next_34b", "train")])
def test_meta_counts_equal_cpu_counts(arch, kind):
    """The same step on ``meta`` and on the CPU: equal FLOPs (by dtype),
    bytes, ops and storage peak."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.sharding import single_device_context

    cfg = get_reduced_config(arch)
    ctx = single_device_context()
    fn = {"train": dryrun._grad_fn(cfg, ctx), "prefill":
          dryrun._prefill_fn(cfg, ctx), "decode": dryrun._decode_fn(cfg, ctx)
          }[kind]
    counts = [rf.count(fn, *_inputs(cfg, kind, dev))[1]
              for dev in ("cpu", "meta")]
    cpu, meta = counts
    assert cpu.flops > 0 and cpu.bytes > 0 and cpu.peak_bytes > 0
    for field in ("flops_by_dtype", "aten_bytes", "peak_bytes", "ops"):
        assert getattr(cpu, field) == getattr(meta, field), field


@pytest.mark.parametrize("arch", ["qwen2p5_3b", "mamba2_1p3b"])
def test_train_flops_under_full_remat_equal_chip_smoke(arch):
    """The dry run's train step (loss gradient under remat "full", then
    AdamW) counts the matmul operations ``chip_smoke.train_flops`` gives
    for the dense and SSM configs."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.sharding import single_device_context
    from repro_torch.training.optimizer import init_opt_state

    cfg = get_reduced_config(arch)
    params, batch = _inputs(cfg, "train", "meta", B=2, S=64)
    step = dryrun._train_step_fn(cfg, single_device_context(), n_micro=2)
    state = {"params": params, "opt": init_opt_state(params)}
    _, c = rf.count(step, state, batch)
    assert c.flops == _chip_smoke().train_flops(cfg, 2, 64)


def test_counts_are_linear_in_the_groups():
    """The reference extrapolates from 1- and 2-group compiles; the port
    counts at full depth, and the counts of 1, 2 and 3 groups lie on one
    line (what that extrapolation assumes)."""
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.launch import dryrun
    from repro_torch.sharding import single_device_context

    base = get_reduced_config("recurrentgemma_2b")
    got = []
    for g in (1, 2, 3):
        cfg = dryrun._with_groups(base, g)
        _, c = rf.count(dryrun._grad_fn(cfg, single_device_context()),
                        *_inputs(cfg, "train", "meta"))
        got.append((c.flops, c.bytes, c.ops))
    for i in range(3):
        assert got[2][i] - got[1][i] == got[1][i] - got[0][i] > 0


def test_peak_of_a_toy_chain():
    """Views count once, a freed tensor leaves the live set, arguments
    are not counted, and views, allocations and in-place writes count
    the bytes they move."""
    x = torch.empty(1000, dtype=torch.float32, device="meta")

    def chain(x):
        a = x * 2                 # 4000 live
        v = a.view(10, 100)       # a view: no bytes, no storage
        b = v + 1                 # 8000 live
        del a, v                  # 4000
        c = b * b                 # 8000
        b.add_(1)                 # in place: nothing new
        return c.sum()            # + 4 bytes

    _, c = rf.count(chain, x)
    assert c.peak_bytes == 8004
    assert c.flops == 0
    # reads and writes: x*2 (8000), v+1 (8000), b*b (8000), add_ (8000),
    # sum (4004)
    assert c.aten_bytes == 4 * 8000 + 4004


def test_indexed_reads_and_writes_count_what_they_select():
    """A gather reads only the rows it selects from its table, an indexed
    write writes (and, accumulating, reads) only the rows it selects: a
    big table touched at a few rows moves a few rows' bytes."""
    table = torch.empty(1 << 20, 64, dtype=torch.float32, device="meta")
    idx = torch.zeros(8, dtype=torch.int64, device="meta")
    rows = 8 * 64 * 4

    def gather(t, i):
        return t[i]

    _, c = rf.count(gather, table, idx)
    assert c.aten_bytes == 8 * 8 + rows + rows       # indices, rows, out

    def put(t, i):
        t[i] = torch.ones(8, 64, device="meta")

    _, c = rf.count(put, table, idx)
    # ones (written), then index_put_: indices and values read, rows
    # written
    assert c.aten_bytes == rows + (8 * 8 + rows + rows)

    def add(t, i):
        t.index_add_(0, i, torch.ones(8, 64, device="meta"))

    _, c = rf.count(add, table, idx)
    assert c.aten_bytes == rows + (8 * 8 + rows + 2 * rows)


def test_kernel_wrappers_report_their_bytes():
    """Each kernel wrapper's call is one scope: what it reports (each
    input read once, each output written once) is in the counted bytes,
    and on the CPU its plain version's aten bytes are kept apart; the
    reckoning is never more than the plain version moved."""
    from repro_torch.core.fm_index import build_fm_index
    from repro_torch.core.pipeline import build_index
    from repro_torch.data.corpus import corpus
    from repro_torch.kernels import ops, radix_sort, traffic
    from repro_torch.kernels.fm_query import (
        fm_query_packed,
        fm_query_unpacked,
    )

    g = torch.Generator().manual_seed(0)
    keys = torch.randint(0, 1 << 30, (8192 * 2,), generator=g,
                         dtype=torch.int32)
    vals = torch.arange(keys.numel(), dtype=torch.int32)

    def sort():
        return radix_sort.radix_sort_blocked((keys, vals), 1, (32,))

    _, c = rf.count(sort)
    assert set(c.kernel_bytes) == {"radix_hist", "radix_pos"}
    passes = 4
    assert c.kernel_bytes["radix_hist"] == passes * traffic.radix_hist_bytes(
        keys.numel(), 8192)
    for name, moved in c.kernel_bytes.items():
        assert 0 < moved <= c.in_scope_bytes[name], name
    assert c.bytes == c.aten_bytes + sum(c.kernel_bytes.values())

    toks = corpus("dna", 3000)
    for pack, name, fq in ((None, "fm_query_packed", fm_query_packed),
                           (False, "fm_query_unpacked", fm_query_unpacked)):
        index = build_index(toks, device="cpu", pack=pack)
        pats = torch.as_tensor(np.stack([toks[i: i + 12]
                                         for i in range(0, 600, 40)]))
        _, c = rf.count(fq, index.fm, pats, 4)
        assert 0 < c.kernel_bytes[name] <= c.in_scope_bytes[name]
        assert c.kernel_bytes[name] == traffic.query_bytes(
            index.fm, pats, 4)[0]
    _, c = rf.count(build_fm_index, index.bwt, index.row, index.sigma, 64)
    assert 0 < c.kernel_bytes["char_histogram"] <= \
        c.in_scope_bytes["char_histogram"]
    r1 = torch.sort(keys).values
    _, c = rf.count(ops.rerank_scan, r1, r1 // 7)
    assert 0 < c.kernel_bytes["rerank_scan"] <= c.in_scope_bytes[
        "rerank_scan"]
    blocks = torch.randint(1, 9, (64, 64), generator=g, dtype=torch.int32)
    q = torch.randint(0, 64, (256,), generator=g, dtype=torch.int32)
    _, c = rf.count(ops.rank_select, blocks, q, q % 9, q)
    assert 0 < c.kernel_bytes["rank_select"] <= c.in_scope_bytes[
        "rank_select"]
    # nothing is reported without a counter recording
    assert traffic.current_scope() is None


def test_meta_is_an_explicit_choice_of_the_lm_helpers_only():
    from repro_torch.configs.base import get_reduced_config
    from repro_torch.core.pipeline import build_index
    from repro_torch.devices import resolve_device
    from repro_torch.models import transformer as tf

    cfg = get_reduced_config("minicpm3_4b")
    cache = tf.init_cache(cfg, 4, 64, device="meta")
    assert all(t.device.type == "meta" for t in tf.tree_leaves(cache))
    assert resolve_device("meta", allow_meta=True) == torch.device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
    with pytest.raises(ValueError, match="unsupported device"):
        build_index(np.arange(1, 9, dtype=np.int32), device="meta")
