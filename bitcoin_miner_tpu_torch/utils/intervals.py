"""The one inclusive-interval algebra primitive.

A copy of the reference package's ``utils/intervals.py``.  The scheduler's
checkpoint hygiene (``_merge_intervals``) and its resume path
(``intersect_intervals``) use it; :class:`IntervalMap` is the span store's
structure, kept whole so both packages share one algebra.  Like
:mod:`.wfq`, this module is the single home of those rules: the coalescing,
intersection, and coverage-planning logic must not drift apart, because
all of it feeds the same bit-exactness contract (a merged result must
equal a from-scratch sweep).

Everything here is over **inclusive** ``[lo, hi]`` integer intervals (the
reference Request range contract) and is pure data — no clocks, threads,
or I/O; callers serialize access (the serve-loop event lock).

The load-bearing subtlety of :class:`IntervalMap` is *when a solved
span's fold answers a sub-range query*.  A span ``[s_lo, s_hi]`` carries
``(min_hash, nonce)`` — the minimum over the WHOLE span and its lowest
argmin nonce.  For a query ``Q`` the span's portion ``P = S ∩ Q`` is
answerable iff the span's argmin nonce lies inside ``Q``: then
``min(P) <= hash(nonce) = min(S) <= min(P)``, so the portion's minimum
IS the span's fold.  If the argmin lies outside ``Q``, the fold only
lower-bounds the portion and the portion must be re-swept — it stays in
the gap list.  Spans recorded at chunk granularity therefore answer far
more sub-ranges than one coalesced mega-span would, which is why
coalescing is *budget-driven* (``max_spans``), not eager.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

Interval = Tuple[int, int]  # inclusive [lo, hi]
Best = Tuple[int, int]  # (min_hash, nonce) — lowest-nonce ties, repo-wide
Span = Tuple[int, int, int, int]  # (lo, hi, min_hash, nonce)


def merge_intervals(intervals: List[Interval]) -> List[Interval]:
    """Coalesce overlapping/adjacent inclusive intervals into a sorted
    disjoint list (checkpoint hygiene: straggler duplicates must not
    double-count work on resume)."""
    out: List[Interval] = []
    for lo, hi in sorted(intervals):
        if out and lo <= out[-1][1] + 1:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def intersect_intervals(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The sorted disjoint intersection of two interval lists.  Used when
    two independent "still unswept" constraints meet (a gap-list Request
    landing on a checkpoint-stashed twin): a nonce needs sweeping only if
    BOTH snapshots say so — each side's complement is already folded into
    a best-so-far by its owner."""
    am, bm = merge_intervals(list(a)), merge_intervals(list(b))
    out: List[Interval] = []
    i = j = 0
    while i < len(am) and j < len(bm):
        lo = max(am[i][0], bm[j][0])
        hi = min(am[i][1], bm[j][1])
        if lo <= hi:
            out.append((lo, hi))
        if am[i][1] < bm[j][1]:
            i += 1
        else:
            j += 1
    return out


def interval_total(intervals: List[Interval]) -> int:
    """Total nonce count across a disjoint interval list."""
    return sum(hi - lo + 1 for lo, hi in intervals)


class IntervalMap:
    """Disjoint solved spans over one data key, each carrying the
    ``(min_hash, nonce)`` fold of its exact range (see module docstring
    for the answerability rule).

    - :meth:`add` keeps spans disjoint: overlapping inserts merge (their
      union is covered by the inputs, so folding minima is exact);
      *adjacent* spans stay separate to preserve sub-range resolution.
    - Over ``max_spans``, :meth:`_shrink` coalesces an adjacent pair
      (lossless for "is it swept", lossy only for resolution), preferring
      the merge that erases the least answerability: the merged span
      keeps the smaller fold, so the OTHER side's argmin stops being
      usable evidence for sub-queries that exclude the winner —
      argmin-placement-aware cost = the losing side's width, tie-broken
      to the narrowest combined span (the old rule).  Only with no
      adjacency left is the narrowest span forgotten (cheapest to
      re-sweep).  Cumulative nonces whose sub-range resolution was lost
      accrue in :attr:`lost_answerability` so the policy is observable
      (``gateway.coalesce_lost``).
    - :meth:`cover` is the planner: fold of answerable portions + the
      gap list a remainder sweep must still cover.

    Not thread-safe: callers serialize, like every policy structure.
    """

    def __init__(self, max_spans: int = 64) -> None:
        self.max_spans = max(1, int(max_spans))
        self._spans: List[Span] = []  # disjoint, sorted by lo
        #: Cumulative nonces whose span-level answerability was lost to
        #: budget shrinking (merged-away argmins + dropped spans).
        self.lost_answerability = 0

    def __len__(self) -> int:
        return len(self._spans)

    def spans(self) -> List[Span]:
        return list(self._spans)

    def add(self, lo: int, hi: int, hash_: int, nonce: int) -> None:
        """Record ``(min_hash, nonce)`` as the solved minimum over
        ``[lo, hi]``.  A malformed span (empty, or argmin outside its own
        range — the fold would then be unusable evidence) is refused."""
        if lo > hi or not (lo <= nonce <= hi):
            return
        merged_lo, merged_hi = lo, hi
        best: Best = (hash_, nonce)
        kept: List[Span] = []
        for s in self._spans:
            if s[0] <= merged_hi and merged_lo <= s[1]:  # overlap: fold in
                merged_lo = min(merged_lo, s[0])
                merged_hi = max(merged_hi, s[1])
                if (s[2], s[3]) < best:
                    best = (s[2], s[3])
            else:
                kept.append(s)
        kept.append((merged_lo, merged_hi, best[0], best[1]))
        kept.sort()
        self._spans = kept
        self._shrink()

    def cover(self, lo: int, hi: int) -> Tuple[Optional[Best], List[Interval]]:
        """Plan the query ``[lo, hi]``: ``(best, gaps)`` where ``best`` is
        the fold over every answerable span portion (None if none) and
        ``gaps`` is the sorted disjoint remainder a sweep must still
        cover.  ``gaps == []`` means fully answered with zero device work;
        folding ``best`` with the gaps' sweep results is bit-identical to
        a from-scratch sweep of the whole query (lowest-nonce ties
        included — every fold is a tuple min)."""
        if lo > hi:
            return None, []
        best: Optional[Best] = None
        gaps: List[Interval] = []
        cursor = lo
        for s_lo, s_hi, h, n in self._spans:
            if s_hi < lo:
                continue
            if s_lo > hi:
                break
            if lo <= n <= hi:  # argmin inside the query: portion answered
                p_lo, p_hi = max(s_lo, lo), min(s_hi, hi)
                if cursor < p_lo:
                    gaps.append((cursor, p_lo - 1))
                if best is None or (h, n) < best:
                    best = (h, n)
                cursor = p_hi + 1
            # else: the span's minimum may live outside the query — its
            # fold cannot answer the portion, which stays in the gap.
        if cursor <= hi:
            gaps.append((cursor, hi))
        return best, merge_intervals(gaps)

    # ------------------------------------------------------------ internals

    def _shrink(self) -> None:
        while len(self._spans) > self.max_spans:
            best_i = -1
            best_cost: Optional[Tuple[int, int]] = None
            for i in range(len(self._spans) - 1):
                a, b = self._spans[i], self._spans[i + 1]
                if a[1] + 1 == b[0]:
                    # The merged span keeps min(a.fold, b.fold); the side
                    # whose argmin loses can no longer answer sub-queries
                    # alone — its width is the answerability cost.
                    loser = b if (a[2], a[3]) <= (b[2], b[3]) else a
                    cost = (loser[1] - loser[0] + 1, b[1] - a[0] + 1)
                    if best_cost is None or cost < best_cost:
                        best_i, best_cost = i, cost
            if best_i >= 0:
                a, b = self._spans[best_i], self._spans[best_i + 1]
                fold = min((a[2], a[3]), (b[2], b[3]))
                self._spans[best_i : best_i + 2] = [
                    (a[0], b[1], fold[0], fold[1])
                ]
                assert best_cost is not None
                self.lost_answerability += best_cost[0]
            else:
                drop = min(
                    range(len(self._spans)),
                    key=lambda i: self._spans[i][1] - self._spans[i][0],
                )
                self.lost_answerability += (
                    self._spans[drop][1] - self._spans[drop][0] + 1
                )
                del self._spans[drop]
