"""Segmented incremental append: grow an index without a full rebuild, on
one device (a port of the JAX package's ``core/segments.py``).

* ``append(tokens)`` builds a *new per-segment FM-index* over just the new
  text with the fast builder: O(new segment), not O(corpus).
* ``count`` sums per-segment counts; ``locate`` maps per-segment positions
  to global coordinates and merges the candidate sets.  With two or more
  stackable segments both go through ONE stacked query launch per served
  batch (``fm_index.count_stacked`` / ``locate_stacked``).
* ``compact`` folds runs of small adjacent segments into one segment.  The
  default strategy lets a cost model pick, per run, between the BWT merges
  of ``core.bwt_merge`` (the pairwise fold and the k-way interleave walk)
  and the raw-token rebuild; ``strategy="rebuild"`` forces the re-sort and
  is the bit-identity oracle for both merge flavors.
* ``save`` / ``load`` persist the catalog as crash-safe generation commits
  (``core.journal``) in the JAX package's on-disk format, byte for byte,
  so a catalog saved by either package loads in the other.

Document semantics: every ``append`` creates one immutable *document*, and
matches never span documents.  Compaction is answer-invariant: a merged
segment indexes the concatenation of its documents' *prepared* texts
(each sentinel-terminated and pad-filled), so counts, and locate whenever a
pattern's occurrences fit within ``k``, are identical before and after.
With MORE than ``k`` occurrences, *which* k are reported follows
per-segment SA order.  All segments share one declared alphabet
(``sigma``), so every segment's pad token sorts above every real token of
any segment.

``count`` / ``locate`` take int32[B, L] PAD-padded patterns (numpy or a
tensor) and return tensors on the catalog's ``device`` (None = the GPU),
so ``serving.engine.FMQueryServer`` serves a catalog unchanged.  Raw tokens
stay on the host (``Segment.tokens``): they are the rebuild input and what
``save`` writes.
"""

from __future__ import annotations

import dataclasses
import io
import json
import math
import os
import warnings

import numpy as np
import torch

from ..devices import resolve_device
from .bwt_merge import (
    context_order_safe,
    kway_eligible,
    kway_walk_steps,
    merge_fm_indexes,
    merge_kway,
)
from .fm_index import (
    StackedFMIndex,
    count_stacked,
    locate_stacked,
    stack_fm_indexes,
    stacked_append,
    stacked_replace_run,
)
from .journal import (
    GenerationJournal,
    fsync_path,
    manifest_entry,
    verify_file,
    write_file_durable,
)
from .dist_suffix_array import DistSAConfig
from .pipeline import (
    SequenceIndex,
    build_index,
    build_index_prepared,
    build_sa_config,
    prepare_tokens,
)

CATALOG_FORMAT = "segmented_index_catalog"
CATALOG_VERSION = 2  # v2: per-segment document tables (``docs``)

# compaction strategies: "merge" = cost-model auto-pick per run,
# "pairwise"/"kway" force one BWT-merge flavor (rebuild fallback for
# ineligible runs), "rebuild" = always re-sort from raw tokens (the
# bit-identity oracle)
COMPACT_STRATEGIES = ("merge", "pairwise", "kway", "rebuild")


def unstored_knobs(cfg) -> dict:
    """The BWTIndexConfig knobs that a saved catalog does not record: the
    query fan-out and the planner's cost model.  ``load`` takes them as
    keyword overrides (else the constructor's defaults)."""
    return dict(
        parallel=cfg.serve_parallel_segments,
        compact_cost_walk_ns=cfg.compact_cost_walk_ns,
        compact_cost_kway_walk_ns=cfg.compact_cost_kway_walk_ns,
        compact_cost_token_ns=cfg.compact_cost_token_ns,
        compact_cost_sort_ns=cfg.compact_cost_sort_ns,
        compact_cost_merge_us=cfg.compact_cost_merge_us,
        compact_trigger_cost_ratio=cfg.compact_trigger_cost_ratio,
    )


@dataclasses.dataclass
class Segment:
    """One immutable index segment plus its placement in global coordinates.

    ``docs`` lists the documents inside the segment's indexed text, in
    *text* order: ``(raw_len, rel_start)`` per document, ``rel_start`` the
    document's raw-token offset relative to ``offset``.  A fresh append is
    one document; compaction concatenates document tables.  ``tokens``
    holds the raw tokens (host numpy) in the same text order.
    """

    seg_id: int
    offset: int            # global position of this segment's first token
    n_tokens: int          # raw appended tokens (no sentinel, no padding)
    index: SequenceIndex
    tokens: np.ndarray     # retained corpus slice — compact() rebuild input
    docs: tuple[tuple[int, int], ...] = None

    def __post_init__(self):
        if self.docs is None:
            self.docs = ((self.n_tokens, 0),)
        self.docs = tuple((int(a), int(b)) for a, b in self.docs)

    @property
    def multi_doc(self) -> bool:
        return len(self.docs) > 1

    def doc_tokens(self) -> list[np.ndarray]:
        """Raw token arrays per document, text order."""
        splits = np.cumsum([d[0] for d in self.docs])[:-1]
        return np.split(self.tokens, splits)


class SegmentedIndex:
    """An FM-index over a growing corpus, as a catalog of immutable segments
    on one device.

    ``sigma`` declares the global alphabet: all appended tokens must lie in
    [1, sigma).  Build knobs (``sample_rate``, ``sa_sample_rate``,
    ``sa_config``, ``pack``, ``compress_sa``, ``reserve_pad``) apply to
    every segment build.  The defaults are the JAX package's, cost-model
    constants included (its CPU calibration); ``from_config`` takes the
    card's from ``configs/bwt_index.py``.
    """

    def __init__(self, sigma: int, *, sample_rate: int = 64,
                 sa_sample_rate: int = 32,
                 sa_config: DistSAConfig = DistSAConfig(),
                 pack: bool | None = None, compress_sa: bool | None = None,
                 segment_min_tokens: int | None = None,
                 parallel: bool | None = None,
                 reserve_pad: bool | None = None,
                 compact_strategy: str = "merge",
                 compact_trigger_ratio: float = 0.5,
                 compact_max_small: int = 8,
                 compact_cost_walk_ns: float = 800.0,
                 compact_cost_kway_walk_ns: float = 1600.0,
                 compact_cost_token_ns: float = 50.0,
                 compact_cost_sort_ns: float = 55.0,
                 compact_cost_merge_us: float = 10000.0,
                 compact_trigger_cost_ratio: float = 0.75,
                 device=None):
        if sigma < 2:
            raise ValueError("sigma must cover at least one real token")
        if compact_strategy not in COMPACT_STRATEGIES:
            raise ValueError(f"unknown compact strategy {compact_strategy!r}")
        self.device = resolve_device(device)
        self.sigma = sigma
        self.sample_rate = sample_rate
        self.sa_sample_rate = sa_sample_rate
        self.sa_config = sa_config
        self.pack = pack
        self.compress_sa = compress_sa
        self.reserve_pad = reserve_pad
        self.segment_min_tokens = segment_min_tokens  # compact() default
        # segment-parallel query fan-out: None = auto (stacked launch
        # whenever >= 2 stackable segments), False = always sequential,
        # True = require the stacked path (raise if segments can't stack)
        self.parallel = parallel
        # background-compaction policy (maybe_compact): "merge" picks
        # pairwise / k-way / rebuild per run through the cost model below;
        # "pairwise"/"kway" force one merge flavor (rebuild stays the
        # fallback for ineligible runs); "rebuild" always re-sorts.
        # ``compact_trigger_ratio`` is the reference's legacy knob, kept for
        # catalog compatibility and not consulted.
        self.compact_strategy = compact_strategy
        self.compact_trigger_ratio = compact_trigger_ratio
        self.compact_max_small = compact_max_small
        # cost-model constants, per-unit wall costs: one sequential
        # pairwise walk step, one k-way walk step, one token of
        # splice/resample work, one token*log2(n) of rebuild sort work, the
        # fixed overhead of one merge operation
        self.compact_cost_walk_ns = compact_cost_walk_ns
        self.compact_cost_kway_walk_ns = compact_cost_kway_walk_ns
        self.compact_cost_token_ns = compact_cost_token_ns
        self.compact_cost_sort_ns = compact_cost_sort_ns
        self.compact_cost_merge_us = compact_cost_merge_us
        self.compact_trigger_cost_ratio = compact_trigger_cost_ratio
        # compaction telemetry: merge-strategy runs that fell back to the
        # O(n log n) rebuild
        self.compact_fallbacks = 0
        self.compact_last_fallback_reason: str | None = None
        self.compact_strategy_counts: dict[str, int] = {}
        self.compact_last_plan: dict | None = None
        self.segments: list[Segment] = []
        self._next_id = 0
        self._stacked_cache: object | None = None
        # segments load() withdrew from serving (checksum/restore failures):
        # catalog entries + reason.  A degraded catalog keeps serving the
        # healthy segments; quarantined global coordinates answer nothing.
        self.quarantined: list[dict] = []
        self._next_offset = 0  # first free global coordinate (survives holes)

    @classmethod
    def from_config(cls, sigma: int, cfg, *, device=None) -> "SegmentedIndex":
        """Build from a BWTIndexConfig's index/lifecycle knobs (the config's
        own ``sigma`` describes the full byte workload; segmented corpora
        pass their actual alphabet)."""
        return cls(
            sigma, sample_rate=cfg.sample_rate,
            sa_sample_rate=cfg.sa_sample_rate,
            sa_config=DistSAConfig(
                engine=cfg.engine, capacity_factor=cfg.capacity_factor,
                qgram=cfg.qgram, qgram_words=cfg.qgram_words,
                discard=cfg.discard, local_sort=cfg.local_sort,
            ),
            pack=cfg.pack, compress_sa=cfg.compress_sa,
            segment_min_tokens=cfg.segment_min_tokens,
            compact_strategy=cfg.compact_strategy,
            compact_trigger_ratio=cfg.compact_trigger_ratio,
            compact_max_small=cfg.compact_max_small,
            device=device, **unstored_knobs(cfg),
        )

    # -- growth --------------------------------------------------------------

    @property
    def total_tokens(self) -> int:
        return sum(s.n_tokens for s in self.segments)

    @property
    def degraded(self) -> bool:
        """True when load() quarantined corrupt segments: the catalog
        serves, but a known slice of the corpus is missing."""
        return bool(self.quarantined)

    @property
    def coord_end(self) -> int:
        """One past the largest assigned global coordinate.  Equal to
        ``total_tokens`` except in a degraded catalog, where quarantined
        segments leave holes that new appends must not reuse."""
        return max(self.total_tokens, self._next_offset)

    def _build(self, tokens: np.ndarray) -> SequenceIndex:
        return build_index(
            tokens, sample_rate=self.sample_rate,
            sa_config=build_sa_config(self.sa_config),
            sa_sample_rate=self.sa_sample_rate, pack=self.pack,
            sigma=self.sigma, compress_sa=self.compress_sa,
            reserve_pad=self.reserve_pad, device=self.device,
        )

    def append(self, tokens) -> Segment:
        """Index new text as a fresh one-document segment; O(len(tokens)).

        ``tokens`` int32[m] in [1, sigma).  The new segment occupies global
        positions [coord_end, coord_end + m).  When a stacked catalog is
        live and has spare bucket capacity, the new segment is written into
        it in place (``fm_index.stacked_append``: no tensor reallocated)."""
        tokens = np.ascontiguousarray(np.asarray(tokens, np.int32))
        if tokens.size == 0:
            raise ValueError("cannot append an empty segment")
        if tokens.min() < 1 or tokens.max() >= self.sigma:
            raise ValueError(
                f"tokens out of declared alphabet [1, {self.sigma})"
            )
        seg = Segment(self._next_id, self.coord_end, len(tokens),
                      self._build(tokens), tokens)
        self._next_offset = seg.offset + seg.n_tokens
        self._next_id += 1
        self.segments.append(seg)
        if isinstance(self._stacked_cache, StackedFMIndex):
            try:
                # the old bucket object is stale after an in-place append:
                # this cache is its only holder
                self._stacked_cache = stacked_append(
                    self._stacked_cache, seg.index.fm
                )
            except ValueError:
                self._stacked_cache = None  # full bucket: re-stack lazily
        else:
            self._stacked_cache = None
        return seg

    # -- compaction ----------------------------------------------------------

    def _prepared_text(self, seg: Segment) -> np.ndarray:
        """The segment's prepared text (sentinel-terminated, pad-filled
        documents, concatenated): the exact token string its index covers,
        re-derived from the retained raw tokens."""
        return np.concatenate([
            prepare_tokens(d, self.sample_rate, self.sigma,
                           self.reserve_pad)[0]
            for d in seg.doc_tokens()
        ])

    def _est_costs(self, ordered: list[Segment]) -> dict:
        """Estimated wall cost (ns) per strategy for a canonically ordered
        run, from run sizes/counts alone (no token access).

        Both merge flavors walk every text but the first (the same
        ``n - n_first`` sequential steps at their own step cost); the
        pairwise fold also splices every intermediate accumulator (the
        suffix sums) and pays the fixed per-merge overhead k-1 times; the
        rebuild re-sorts everything."""
        lens = [s.n_tokens + len(s.docs) for s in ordered]  # ~prepared
        n = sum(lens)
        w = max(0, sum(lens[1:]) - 1)  # sequential walk steps
        fixed = self.compact_cost_merge_us * 1e3
        # right-assoc fold accumulator sizes (includes the final splice)
        suffixes = np.cumsum(lens[::-1])[1:]
        return {
            "pairwise": self.compact_cost_walk_ns * w
            + self.compact_cost_token_ns * float(suffixes.sum())
            + fixed * (len(lens) - 1),
            "kway": self.compact_cost_kway_walk_ns * w
            + self.compact_cost_token_ns * n + fixed,
            "rebuild": self.compact_cost_sort_ns * n
            * math.log2(max(n, 2)),
        }

    def _plan_run(self, run: list[Segment],
                  strategy: str | None = None) -> tuple[list[Segment], dict]:
        """(canonical text order, plan) for a compaction run.

        Candidate orders (stable, ties in corpus order): largest-first (the
        largest text is never walked) and, when it differs, singles-first
        (multi-document segments at the right end: a single-document left
        operand is provably context-order safe).  The canonical layout does
        not depend on the requested strategy, so every strategy builds the
        same document order and they stay bit-identical oracles of each
        other.  The plan picks the cheapest estimated strategy
        (``_est_costs``) among those the run is eligible for
        (``bwt_merge.kway_eligible`` plus context-order safety of every
        multi-document operand against the text after it); ``strategy``
        forces one flavor ("merge" = cost-model auto); ineligible runs
        record the fallback reason."""
        if strategy is None:
            strategy = self.compact_strategy
        bysize = sorted(run, key=lambda s: -s.n_tokens)
        singles_first = ([s for s in bysize if not s.multi_doc]
                         + [s for s in bysize if s.multi_doc])
        candidates = [bysize]
        if singles_first != bysize:
            candidates.append(singles_first)
        ordered, reason = bysize, None
        for cand in candidates:
            reason = kway_eligible([s.index.fm for s in cand])
            # only multi-document left operands need the token-level scan
            if reason is None and any(s.multi_doc for s in cand[:-1]):
                texts = [self._prepared_text(s) for s in cand]
                for i in range(len(texts) - 1):
                    if not cand[i].multi_doc:
                        continue
                    if not context_order_safe(
                        texts[i], np.concatenate(texts[i + 1:])
                    ):
                        reason = (
                            f"operand {i} is not context-order safe "
                            f"against the texts that follow it "
                            f"(tied document tails)"
                        )
                        break
            if reason is None:
                ordered = cand
                break
        if strategy == "rebuild":
            reason = "rebuild requested"
        est = self._est_costs(ordered)
        if reason is not None:
            chosen = "rebuild"
        elif strategy in ("pairwise", "kway"):
            chosen = strategy
        else:  # cost model: cheapest eligible strategy wins
            chosen = min(est, key=est.get)
            if len(ordered) == 2 and chosen == "kway":
                chosen = "pairwise"  # identical cost and walk at k = 2
        return ordered, {
            "strategy": chosen, "requested": strategy, "reason": reason,
            "est": est, "est_walk_steps": (
                kway_walk_steps(s.index.fm.length for s in ordered)
                if reason is None else 0
            ),
        }

    def _merge_run(self, run: list[Segment], strategy: str) -> Segment:
        """Fold one run of adjacent segments into a single segment,
        recording the planner's decision (and any rebuild fallback) in the
        compaction telemetry."""
        ordered, plan = self._plan_run(run, strategy)
        chosen = plan["strategy"]
        if plan["reason"] is not None and plan["requested"] != "rebuild":
            self.compact_fallbacks += 1
            self.compact_last_fallback_reason = plan["reason"]
            warnings.warn(
                f"compaction fell back to an O(n log n) rebuild: "
                f"{plan['reason']}", RuntimeWarning, stacklevel=3,
            )
        offset = min(s.offset for s in run)
        docs, toks = [], []
        for seg in ordered:
            base = seg.offset - offset
            docs.extend((ln, base + rs) for ln, rs in seg.docs)
            toks.append(seg.tokens)
        tokens = np.concatenate(toks)
        n_tokens = sum(s.n_tokens for s in run)

        fm = None
        if chosen == "kway":
            fm = merge_kway([s.index.fm for s in ordered],
                            compress_sa=self.compress_sa, pack=self.pack)
        elif chosen == "pairwise":
            acc = ordered[-1].index.fm
            for seg in reversed(ordered[:-1]):
                acc = merge_fm_indexes(seg.index.fm, acc,
                                       compress_sa=self.compress_sa,
                                       pack=self.pack)
            fm = acc
        plan["actual_walk_steps"] = (
            kway_walk_steps(s.index.fm.length for s in ordered)
            if fm is not None else 0
        )
        self.compact_last_plan = plan
        if fm is None:  # rebuild fallback/oracle: same text, same layout
            texts, sigmas = [], []
            for seg in ordered:
                for d in seg.doc_tokens():
                    s, sig = prepare_tokens(d, self.sample_rate, self.sigma,
                                            self.reserve_pad)
                    texts.append(s)
                    sigmas.append(sig)
            index = build_index_prepared(
                np.concatenate(texts), max(sigmas),
                sample_rate=self.sample_rate,
                sa_config=build_sa_config(self.sa_config),
                sa_sample_rate=self.sa_sample_rate, pack=self.pack,
                compress_sa=self.compress_sa,
                text_length=sum(ln + 1 for ln, _ in docs),
                device=self.device,
            )
        else:
            index = SequenceIndex(
                fm, None, fm.bwt, fm.row, fm.sigma, fm.length,
                sum(ln + 1 for ln, _ in docs),
            )
        # counts completed merges only: a crash mid-merge leaves the
        # operands (and the counters) exactly as they were
        self.compact_strategy_counts[chosen] = (
            self.compact_strategy_counts.get(chosen, 0) + 1
        )
        return Segment(self._next_id_bump(), offset, n_tokens, index,
                       tokens, tuple(docs))

    def compact(self, min_tokens: int | None = None,
                strategy: str | None = None) -> int:
        """Fold runs of adjacent small segments into one segment each.

        Segments smaller than ``min_tokens`` (None = the constructor's
        ``segment_min_tokens``; every segment when that is also None) are
        grouped into maximal adjacent runs; each run of >= 2 becomes a
        single segment.  Global coordinates are preserved and answers are
        invariant (counts and in-k locate sets).  Returns the number of
        merges performed.  ``strategy`` as in ``_plan_run``; ineligible
        runs fall back to a rebuild, counted in ``compact_fallbacks`` and
        warned about.  A live stacked catalog is patched incrementally
        (``fm_index.stacked_replace_run``)."""
        if strategy is None:
            strategy = self.compact_strategy
        if strategy not in COMPACT_STRATEGIES:
            raise ValueError(f"unknown compact strategy {strategy!r}")
        if min_tokens is None:
            min_tokens = self.segment_min_tokens
        merged, out, run = 0, [], []
        replaces = []  # (old_start_idx, run_len) per merge, in order
        idx = 0

        def close_run():
            nonlocal merged
            if len(run) >= 2:
                out.append(self._merge_run(run, strategy))
                replaces.append((idx - len(run), len(run)))
                merged += 1
            else:
                out.extend(run)
            run.clear()

        for seg in self.segments:
            if min_tokens is None or seg.n_tokens < min_tokens:
                run.append(seg)
            else:
                close_run()
                out.append(seg)
            idx += 1
        close_run()
        self.segments = out
        self._update_stacked_after_compact(replaces, out)
        return merged

    def _update_stacked_after_compact(self, replaces, out) -> None:
        """Incrementally patch the stacked catalog for each merged run
        (indices shift as earlier runs collapse); any misfit (merged
        segment larger than the block bucket) drops the cache for a lazy
        full re-stack."""
        st = self._stacked_cache
        if not isinstance(st, StackedFMIndex) or not replaces:
            if replaces:
                self._stacked_cache = None
            return
        shift = 0  # earlier runs collapse len -> 1, shifting later indices
        try:
            for start, length in replaces:
                st = stacked_replace_run(
                    st, start - shift, length, out[start - shift].index.fm
                )
                shift += length - 1
        except (ValueError, AttributeError):
            self._stacked_cache = None
            return
        self._stacked_cache = st

    def maybe_compact(self, strategy: str | None = None) -> int:
        """Run ``compact`` when the background policy triggers.

        For each maximal adjacent run of >= 2 segments below
        ``segment_min_tokens``, compact fires when the cheapest estimated
        merge costs at most ``compact_trigger_cost_ratio`` of the estimated
        rebuild, OR when re-sorting the run costs no more than one merge's
        fixed overhead, OR when the run has grown to ``compact_max_small``
        segments (the fan-out backstop).  Returns merges performed (0 when
        the trigger does not fire)."""
        mt = self.segment_min_tokens
        if mt is None or len(self.segments) < 2:
            return 0
        run: list[Segment] = []
        runs: list[list[Segment]] = []
        for seg in self.segments:
            if seg.n_tokens < mt:
                run.append(seg)
            elif run:
                runs.append(run)
                run = []
        if run:
            runs.append(run)
        for r in runs:
            if len(r) < 2:
                continue
            if len(r) >= self.compact_max_small:
                return self.compact(strategy=strategy)
            est = self._est_costs(sorted(r, key=lambda s: -s.n_tokens))
            best = min(est["pairwise"], est["kway"])
            if (best <= self.compact_trigger_cost_ratio * est["rebuild"]
                    or est["rebuild"] <= self.compact_cost_merge_us * 1e3):
                return self.compact(strategy=strategy)
        return 0

    def _next_id_bump(self) -> int:
        i = self._next_id
        self._next_id += 1
        return i

    # -- queries -------------------------------------------------------------

    def _stacked(self):
        """The stacked bucket layout for segment-parallel fan-out, or None
        when the sequential path applies (parallel=False, < 2 segments, or
        an unstackable mixed catalog under parallel=None).  Cached; append
        and compact patch the cache when the bucket fits and invalidate it
        otherwise."""
        if self.parallel is False or not self.segments:
            return None
        if self.parallel is None and len(self.segments) < 2:
            return None
        if self._stacked_cache is None:
            try:
                self._stacked_cache = stack_fm_indexes(
                    [s.index.fm for s in self.segments]
                )
            except ValueError:
                if self.parallel:
                    raise
                self._stacked_cache = False  # unstackable: remember that
        return self._stacked_cache or None

    def _patterns(self, patterns) -> torch.Tensor:
        return torch.as_tensor(patterns, dtype=torch.int32,
                               device=self.device)

    def count(self, patterns) -> torch.Tensor:
        """Exact-match counts for int32[B, L] PAD-padded patterns: the sum
        of independent per-segment counts (int64[B] on the device).  One
        stacked launch when the catalog stacks; bit-identical per-segment
        counts either way, so an identical sum."""
        patterns = self._patterns(patterns)
        st = self._stacked()
        if st is not None:
            per = count_stacked(st, patterns)[: st.n_seg]
            return per.to(torch.int64).sum(dim=0)
        total = torch.zeros(patterns.shape[0], dtype=torch.int64,
                            device=self.device)
        for seg in self.segments:
            total += seg.index.count(patterns).to(torch.int64)
        return total

    def _to_global(self, seg: Segment, pos: torch.Tensor, used: torch.Tensor,
                   fill: int) -> torch.Tensor:
        """Map segment-text positions (int64) to global raw-token
        coordinates.  Single-document segments shift by the segment offset;
        merged segments map piecewise through the document table (position
        -> owning prepared document -> that document's global raw start).
        Garbage lanes (``~used``) resolve to ``fill``."""
        if not seg.multi_doc:
            return torch.where(used, pos + seg.offset, fill)
        r = self.sample_rate
        dev = pos.device
        lens = torch.tensor([d[0] for d in seg.docs], dtype=torch.int64,
                            device=dev)
        rels = torch.tensor([d[1] for d in seg.docs], dtype=torch.int64,
                            device=dev)
        padded = -(-(lens + 1) // r) * r
        u_starts = torch.cumsum(padded, 0) - padded
        p = torch.clamp(pos, 0, int(padded.sum()) - 1)
        d = torch.searchsorted(u_starts, p, right=True) - 1
        g = seg.offset + rels[d] + (p - u_starts[d])
        return torch.where(used, g, fill)

    def locate(self, patterns, k: int):
        """First-k *global* occurrence positions per pattern.

        Returns (positions int64[B, k] sorted ascending, ``coord_end``
        filling unused slots; counts int64[B] clipped to k), on the device.
        The k kept positions are the k smallest global positions among the
        per-segment candidates (each segment contributes its first k in SA
        order).  One stacked launch when the catalog stacks; the
        per-segment candidates are bit-identical to the sequential path's,
        so the merged answer is too."""
        patterns = self._patterns(patterns)
        st = self._stacked()
        B = patterns.shape[0]
        fill = self.coord_end
        cand = [torch.full((B, 1), fill, dtype=torch.int64,
                           device=self.device)]
        slot = torch.arange(k, device=self.device)
        if st is not None:
            # every segment at once: single-document segments shift by one
            # broadcast add of their offsets, merged ones map through their
            # document tables
            pos_all, cnt_all = locate_stacked(st, patterns, k)
            pos = pos_all[: st.n_seg].to(torch.int64)
            cnt = cnt_all[: st.n_seg].to(torch.int64)
            used = slot < cnt[..., None]
            offsets = torch.tensor([seg.offset for seg in self.segments],
                                   dtype=torch.int64, device=self.device)
            glob = torch.where(used, pos + offsets[:, None, None], fill)
            for i, seg in enumerate(self.segments):
                if seg.multi_doc:
                    glob[i] = self._to_global(seg, pos[i], used[i], fill)
            cand.append(glob.permute(1, 0, 2).reshape(B, -1))
            counts = cnt.sum(0)
        else:
            counts = torch.zeros(B, dtype=torch.int64, device=self.device)
            for seg in self.segments:
                pos, cnt = seg.index.locate(patterns, k)
                cnt = cnt.to(torch.int64)
                # only the first cnt[b] slots hold real (segment-local)
                # positions
                cand.append(self._to_global(seg, pos.to(torch.int64),
                                            slot < cnt[:, None], fill))
                counts += cnt
        allpos = torch.sort(torch.cat(cand, dim=1), dim=1).values[:, :k]
        if allpos.shape[1] < k:
            allpos = torch.nn.functional.pad(
                allpos, (0, k - allpos.shape[1]), value=fill)
        return allpos, torch.clamp(counts, max=k)

    # -- lifecycle -----------------------------------------------------------

    def catalog(self) -> list[dict]:
        """JSON-able summary of the segment layout (id, offset, size,
        document table)."""
        return [
            {"seg_id": s.seg_id, "offset": s.offset, "n_tokens": s.n_tokens,
             "docs": [list(d) for d in s.docs]}
            for s in self.segments
        ]

    def _catalog_payload(self) -> dict:
        return {
            "format": CATALOG_FORMAT, "version": CATALOG_VERSION,
            "sigma": self.sigma, "sample_rate": self.sample_rate,
            "sa_sample_rate": self.sa_sample_rate,
            "pack": self.pack, "compress_sa": self.compress_sa,
            "reserve_pad": self.reserve_pad,
            "segment_min_tokens": self.segment_min_tokens,
            "compact_strategy": self.compact_strategy,
            "compact_trigger_ratio": self.compact_trigger_ratio,
            "compact_max_small": self.compact_max_small,
            "compact_fallbacks": self.compact_fallbacks,
            "compact_last_fallback_reason": self.compact_last_fallback_reason,
            "sa_config": self.sa_config._asdict(),
            "next_id": self._next_id, "next_offset": self.coord_end,
            "segments": self.catalog(),
        }

    @staticmethod
    def _seg_relpaths(directory: str, name: str) -> list[str]:
        """Every file of one segment directory, as "/"-joined relpaths."""
        out = []
        for root, _, names in os.walk(os.path.join(directory, name)):
            for fn in names:
                rel = os.path.relpath(os.path.join(root, fn), directory)
                out.append(rel.replace(os.sep, "/"))
        return sorted(out)

    def save(self, directory: str) -> None:
        """Persist catalog + every segment as one crash-safe generation
        commit (``core.journal``).

        Incremental: segments are immutable and ids never reused, so a
        segment directory that already exists is skipped (its checksums
        carry over from the previous committed generation), and directories
        orphaned by ``compact`` are garbage-collected only after the new
        generation's pointer flip: a crash at any point of the save leaves
        the previous generation loadable."""
        from .index_io import save_index

        os.makedirs(directory, exist_ok=True)
        journal = GenerationJournal(directory)
        prev = journal.committed()
        prev_files = prev["files"] if prev else {}

        # phase 1 — stage: write + fsync every new artifact; nothing the
        # committed generation references is touched
        files: dict[str, dict] = {}
        for seg in self.segments:
            name = f"seg_{seg.seg_id:06d}"
            seg_dir = os.path.join(directory, name)
            fresh = not os.path.exists(os.path.join(seg_dir, "tokens.npz"))
            if fresh:
                save_index(seg_dir, seg.index)
                buf = io.BytesIO()
                np.savez(buf, tokens=seg.tokens)
                write_file_durable(os.path.join(seg_dir, "tokens.npz"),
                                   buf.getvalue())
            for rel in self._seg_relpaths(directory, name):
                if not fresh and rel in prev_files:
                    files[rel] = prev_files[rel]  # immutable: CRC carries
                else:
                    if fresh and not rel.endswith("tokens.npz"):
                        fsync_path(os.path.join(directory, rel))
                    files[rel] = manifest_entry(directory, rel)

        # phase 2 — commit: durable generation manifest, atomic pointer
        journal.commit(self._catalog_payload(), files)

        # post-commit: legacy-readable mirror + garbage collection of
        # orphaned segments, older generations, and staging debris
        write_file_durable(
            os.path.join(directory, "catalog.json"),
            json.dumps(self._catalog_payload(), indent=2).encode(),
        )
        journal.collect_garbage(files)

    @classmethod
    def load(cls, directory: str, **kwargs) -> "SegmentedIndex":
        """Restore a saved segmented index onto ``device`` (a keyword; None
        = the GPU).

        Reads the committed generation (a torn save rolls back to the last
        committed one and its staged debris is swept), verifies every
        artifact's CRC32 against the generation manifest, and restores the
        healthy segments bit-identically via ``index_io``.  A segment that
        fails verification or restore is quarantined (moved under
        ``quarantine/``, listed in ``self.quarantined``) instead of failing
        the load.  Build knobs come back from the catalog; the cost-model
        constants are not stored, so they take the constructor's defaults,
        as in the reference.  ``kwargs`` override any of them (the launcher
        passes its config's, ``unstored_knobs``).  Directories
        without a journal (a bare ``catalog.json``) load unverified."""
        from .index_io import IndexIOError, restore_index

        journal = GenerationJournal(directory)
        man = journal.committed()
        if man is not None:
            cat, files = man["catalog"], man["files"]
            journal.collect_garbage(files)  # recovery: sweep torn saves
        else:  # legacy layout: unverified catalog.json
            with open(os.path.join(directory, "catalog.json")) as f:
                cat = json.load(f)
            files = None
        if cat.get("format") != CATALOG_FORMAT:
            raise ValueError(f"not a segment catalog: {directory}")
        if cat.get("version", 0) > CATALOG_VERSION:
            raise ValueError(
                f"catalog version {cat['version']} > supported "
                f"{CATALOG_VERSION}"
            )
        knobs = dict(
            sample_rate=cat["sample_rate"],
            sa_sample_rate=cat["sa_sample_rate"],
            pack=cat.get("pack"), compress_sa=cat.get("compress_sa"),
            reserve_pad=cat.get("reserve_pad"),
            segment_min_tokens=cat.get("segment_min_tokens"),
            compact_strategy=cat.get("compact_strategy", "merge"),
            compact_trigger_ratio=cat.get("compact_trigger_ratio", 0.5),
            compact_max_small=cat.get("compact_max_small", 8),
            sa_config=DistSAConfig(**cat.get(
                "sa_config", DistSAConfig()._asdict()
            )),
        )
        knobs.update(kwargs)
        self = cls(cat["sigma"], **knobs)
        self._next_id = cat["next_id"]
        # fallback telemetry survives restarts
        self.compact_fallbacks = int(cat.get("compact_fallbacks", 0))
        self.compact_last_fallback_reason = cat.get(
            "compact_last_fallback_reason"
        )
        for ent in cat["segments"]:
            name = f"seg_{ent['seg_id']:06d}"
            seg_dir = os.path.join(directory, name)
            reason = None
            if files is not None:
                rels = [r for r in files if r.startswith(name + "/")]
                if not rels:
                    reason = "no files recorded in the generation manifest"
                for rel in rels:
                    err = verify_file(directory, rel, files[rel])
                    if err:
                        reason = f"{rel}: {err}"
                        break
            if reason is None:
                try:
                    index = restore_index(seg_dir, device=self.device)
                    with np.load(os.path.join(seg_dir, "tokens.npz")) as z:
                        tokens = z["tokens"]
                    if len(tokens) != ent["n_tokens"]:
                        reason = (f"tokens.npz holds {len(tokens)} tokens, "
                                  f"catalog says {ent['n_tokens']}")
                except (IndexIOError, OSError, KeyError, ValueError) as e:
                    reason = f"restore failed: {e}"
            if reason is not None:
                journal.quarantine(name)
                self.quarantined.append({**ent, "reason": reason})
                continue
            self.segments.append(Segment(
                ent["seg_id"], ent["offset"], ent["n_tokens"], index,
                tokens, tuple(tuple(d) for d in ent.get("docs", []))
                or ((ent["n_tokens"], 0),),
            ))
        ends = [e["offset"] + e["n_tokens"]
                for e in cat["segments"]] + [cat.get("next_offset", 0)]
        self._next_offset = max(ends, default=0)
        return self
