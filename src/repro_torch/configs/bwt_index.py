"""The paper's own workload as a config: BWT index construction (on one
device or distributed over a mesh) + FM-index query serving.  A copy of
the knobs of the JAX package's ``configs/bwt_index.py`` that this package
reads.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class BWTIndexConfig:
    name: str = "bwt_index"
    family: str = "index"
    n: int = 1 << 28              # 256 Mi tokens (PROTEINS/DNA-scale, §3)
    sigma: int = 257              # byte alphabet + sentinel
    # the mesh build's engine (core/dist_suffix_array.py DistSAConfig):
    # "samplesort" (the paper's range shuffle) or "bitonic"
    engine: str = "samplesort"
    capacity_factor: float = 2.0
    # build-engine knobs: fused keys are always on; these gate the packed
    # q-gram init, active-suffix discarding, and the local sort
    qgram: bool = True            # rank by q packed chars, start at h=q
    qgram_words: int = 2          # 32-bit words per init key (64-bit logical)
    discard: bool = True          # drop unique-rank suffixes from the loop
    local_sort: str = "auto"      # "compare" | "radix" | "auto" (radix on GPU)
    sample_rate: int = 64         # FM Occ checkpoint spacing
    query_batch: int = 1024
    query_len: int = 32
    # the mesh build's doubling rounds (DistSAConfig.rounds); None ->
    # ceil(log2 n).  A capped budget can leave long repeats unsorted.
    rounds: int | None = None

    # query engine: pack/sa_sample_rate feed pipeline.build_index, the
    # serve_* knobs feed serving.engine.FMQueryServer.from_config
    pack: bool | None = None      # None: bit-pack whenever sigma <= 16
    sa_sample_rate: int = 32      # SA sampling stride for locate() (0 = off)
    compress_sa: bool | None = None  # None: bit-pack SA values when smaller
    locate_k: int = 16            # occurrences returned per locate query
    serve_length_buckets: tuple[int, ...] = (8, 16, 32, 64)
    serve_max_batch: int = 1024   # micro-batch cap per bucket

    # async frontend (serving/frontend.py): admission-controlled queue in
    # front of FMQueryServer.flush; overload sheds (Rejected) instead of
    # growing without bound; per-bucket p50/p99 tracked against the SLOs
    serve_queue_depth: int = 8192     # admission bound; beyond this -> shed
    serve_max_wait_ms: float = 2.0    # flush coalescing window
    serve_slo_p99_ms: float = 50.0    # per-bucket p99 target, count queries
    serve_slo_p99_ms_locate: float = 200.0  # same, locate (LF-walk heavy)
    serve_parallel_segments: bool | None = None  # SegmentedIndex fan-out
                                  # (None = auto: stacked when >= 2)
    # growth-op fault policy (frontend appends/compactions): transient
    # failures retry with capped exponential backoff; a compaction that
    # exhausts its retries is quarantined (pre-compact generation serves)
    serve_growth_retries: int = 3
    serve_growth_backoff_ms: float = 5.0

    # index persistence: the defaults of launch.serve's --ckpt-dir /
    # --ckpt-keep (core/index_io.py checkpoints)
    ckpt_dir: str | None = None   # None = index dies with the process
    ckpt_keep: int = 3            # retained checkpoint steps

    # segmented catalog (core/segments.py, SegmentedIndex.from_config):
    # segments under segment_min_tokens merge on compact().  The background
    # policy (maybe_compact, run by launch.serve after each --append) and
    # its planner as in the reference: "merge" = cost-model pick per run
    # between the pairwise fold, the k-way walk and the rebuild; a run of
    # small segments compacts when the cheapest merge estimate is at most
    # trigger_cost_ratio of the rebuild's, when its rebuild costs no more
    # than one merge's fixed overhead, or at compact_max_small segments.
    # compact_trigger_ratio is the reference's legacy knob, kept for the
    # catalog only.
    segment_min_tokens: int = 1 << 22
    compact_strategy: str = "merge"
    compact_trigger_ratio: float = 0.5
    compact_max_small: int = 8
    compact_trigger_cost_ratio: float = 0.75
    # cost-model constants measured on the card (chip_smoke.py phase 7;
    # NVIDIA H100 80GB HBM3, power limit 700.00 W): one pairwise walk step
    # 0.334 ns and one k-way step 0.393 ns (DNA, packed rows: the chained
    # merge_walk kernel, each walk's host-clock time over its steps, run M5
    # in PERF.md; the one-chain kernel before it took 739.7 and 1051.2 ns
    # in run Z1), 8.49 ns per merged token for the splice and
    # build_fm_index of walk (a), 0.286 ns per token*log2(n) for the
    # rebuild, and 970 us per merge for its precompute (0.985 ms for (a)'s
    # k-way stack, 0.954 ms per pairwise fold of (b)), these three from
    # run Z1.  The splice and build alone cost more per token than the
    # sort, so the planner still rebuilds every run under
    # segment_min_tokens.
    compact_cost_walk_ns: float = 0.334
    compact_cost_kway_walk_ns: float = 0.393
    compact_cost_token_ns: float = 8.49
    compact_cost_sort_ns: float = 0.286
    compact_cost_merge_us: float = 970.0

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


CONFIG = BWTIndexConfig()


def reduced() -> BWTIndexConfig:
    return CONFIG.replace(n=1 << 12, query_batch=8, query_len=8, rounds=None,
                          sa_sample_rate=8, locate_k=4,
                          serve_length_buckets=(4, 8), serve_max_batch=8,
                          serve_queue_depth=64, serve_max_wait_ms=1.0)
