"""The paper's own workload as a config: single-device BWT index
construction + FM-index query serving.  A copy of the knobs of the JAX
package's ``configs/bwt_index.py`` that this package reads.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class BWTIndexConfig:
    name: str = "bwt_index"
    n: int = 1 << 28              # 256 Mi tokens (PROTEINS/DNA-scale, §3)
    sigma: int = 257              # byte alphabet + sentinel
    # build-engine knobs: fused keys are always on; these gate the packed
    # q-gram init, active-suffix discarding, and the local sort
    qgram: bool = True            # rank by q packed chars, start at h=q
    qgram_words: int = 2          # 32-bit words per init key (64-bit logical)
    discard: bool = True          # drop unique-rank suffixes from the loop
    local_sort: str = "auto"      # "compare" | "radix" | "auto" (radix on GPU)
    sample_rate: int = 64         # FM Occ checkpoint spacing
    query_batch: int = 1024
    query_len: int = 32

    # query engine: pack/sa_sample_rate feed pipeline.build_index, the
    # serve_* knobs feed serving.engine.FMQueryServer.from_config
    pack: bool | None = None      # None: bit-pack whenever sigma <= 16
    sa_sample_rate: int = 32      # SA sampling stride for locate() (0 = off)
    compress_sa: bool | None = None  # None: bit-pack SA values when smaller
    locate_k: int = 16            # occurrences returned per locate query
    serve_length_buckets: tuple[int, ...] = (8, 16, 32, 64)
    serve_max_batch: int = 1024   # micro-batch cap per bucket

    # index persistence: the defaults of launch.serve's --ckpt-dir /
    # --ckpt-keep (core/index_io.py checkpoints)
    ckpt_dir: str | None = None   # None = index dies with the process
    ckpt_keep: int = 3            # retained checkpoint steps

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)


CONFIG = BWTIndexConfig()


def reduced() -> BWTIndexConfig:
    return CONFIG.replace(n=1 << 12, query_batch=8, query_len=8,
                          sa_sample_rate=8, locate_k=4,
                          serve_length_buckets=(4, 8), serve_max_batch=8)
