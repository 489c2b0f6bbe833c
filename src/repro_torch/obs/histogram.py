"""Fixed log-bucket latency histograms.

The observability layer needs a latency *distribution* per (unit,
signature), not just a sum: planning decisions (hot vs cold, specialize vs
generic) care about tails, and cross-process aggregation must be O(1) per
fold.  Both constraints pick the same structure — a histogram over
**fixed power-of-two nanosecond buckets**:

* recording is one ``int.bit_length`` and an array increment (no
  allocation, no sorting, safe on the crossing hot path);
* ``merge`` is element-wise addition, which is **associative and
  commutative**, so worker histograms can be folded in any order — the
  cluster tier merges per-worker sets without coordination;
* bucket counts are **conserved**: ``sum(counts) == count`` always, and a
  merge's bucket totals are exactly the sum of its inputs' (property-tested
  in ``tests/test_obs.py``).

Bucket ``0`` holds everything below 1 µs (2^10 ns); bucket ``i`` (i ≥ 1)
holds ``[2^(9+i), 2^(10+i))`` ns; the last bucket is open-ended.  The
exact ``sum_ns``/``min_ns``/``max_ns`` ride along so means stay precise
even though bucket membership is quantized.
"""
from __future__ import annotations

from dataclasses import dataclass, field

#: Number of fixed buckets: sub-µs up to ≥ ~17 s, one octave each.
N_BUCKETS = 26

#: Inclusive upper edge (ns) of each bucket; the last is open-ended.
BUCKET_UPPER_NS = tuple(1 << (10 + i) for i in range(N_BUCKETS - 1)) + (None,)


def bucket_index(ns: int) -> int:
    """Bucket for a duration of ``ns`` nanoseconds (clamped at both ends)."""
    if ns < 1024:
        return 0
    return min(N_BUCKETS - 1, int(ns).bit_length() - 10)


@dataclass
class Histogram:
    """One latency distribution: fixed log buckets + exact sum/min/max."""

    counts: list[int] = field(default_factory=lambda: [0] * N_BUCKETS)
    count: int = 0
    sum_ns: int = 0
    min_ns: int | None = None
    max_ns: int = 0

    def record(self, ns: int) -> None:
        ns = max(0, int(ns))
        self.counts[bucket_index(ns)] += 1
        self.count += 1
        self.sum_ns += ns
        self.max_ns = max(self.max_ns, ns)
        self.min_ns = ns if self.min_ns is None else min(self.min_ns, ns)

    def merge(self, other: "Histogram") -> "Histogram":
        """Associative fold: a fresh histogram, inputs untouched."""
        out = Histogram(
            counts=[a + b for a, b in zip(self.counts, other.counts)],
            count=self.count + other.count,
            sum_ns=self.sum_ns + other.sum_ns,
            max_ns=max(self.max_ns, other.max_ns),
        )
        mins = [m for m in (self.min_ns, other.min_ns) if m is not None]
        out.min_ns = min(mins) if mins else None
        return out

    def copy(self) -> "Histogram":
        return Histogram(counts=list(self.counts), count=self.count,
                         sum_ns=self.sum_ns, min_ns=self.min_ns,
                         max_ns=self.max_ns)

    @property
    def total_seconds(self) -> float:
        return self.sum_ns * 1e-9

    @property
    def mean_ns(self) -> float:
        return self.sum_ns / self.count if self.count else 0.0

    def quantile_ns(self, q: float) -> int:
        """Upper-edge estimate of the ``q`` quantile (0 < q <= 1)."""
        if not self.count:
            return 0
        rank = max(1, int(q * self.count + 0.999999))
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= rank:
                upper = BUCKET_UPPER_NS[i]
                return self.max_ns if upper is None else min(upper,
                                                             self.max_ns)
        return self.max_ns

    def as_dict(self) -> dict:
        return {
            "count": self.count,
            "sum_ns": self.sum_ns,
            "min_ns": self.min_ns,
            "max_ns": self.max_ns,
            "counts": list(self.counts),
        }


class HistogramSet:
    """A keyed family of :class:`Histogram`\\ s — ``(name, kind)`` tuples.

    The report layer keys by ``(unit_name, signature)``; the tracer keys by
    ``(span_name, span_kind)``.  Either way the set itself merges
    associatively because its members do.  Bounded at ``max_keys`` so a
    signature explosion cannot grow without limit — overflow records land
    in the ``("<overflow>", "")`` bucket (still conserving counts).
    """

    MAX_KEYS = 512
    OVERFLOW_KEY = ("<overflow>", "")

    __slots__ = ("_h",)

    def __init__(self, items: dict[tuple[str, str], Histogram] | None = None):
        self._h: dict[tuple[str, str], Histogram] = dict(items or {})

    def record(self, key: tuple[str, str], ns: int) -> None:
        h = self._h.get(key)
        if h is None:
            if len(self._h) >= self.MAX_KEYS:
                key = self.OVERFLOW_KEY
                h = self._h.get(key)
            if h is None:
                h = self._h[key] = Histogram()
        h.record(ns)

    def get(self, key: tuple[str, str]) -> Histogram | None:
        return self._h.get(key)

    def items(self):
        return self._h.items()

    def keys(self):
        return self._h.keys()

    def __len__(self) -> int:
        return len(self._h)

    def __bool__(self) -> bool:
        return bool(self._h)

    def __eq__(self, other) -> bool:
        return isinstance(other, HistogramSet) and self._h == other._h

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"HistogramSet({len(self._h)} keys, {self.total_count} records)"

    @property
    def total_count(self) -> int:
        return sum(h.count for h in self._h.values())

    def copy(self) -> "HistogramSet":
        return HistogramSet({k: h.copy() for k, h in self._h.items()})

    def merge(self, other: "HistogramSet") -> "HistogramSet":
        """Associative fold into a fresh set; inputs untouched."""
        out = self.copy()
        for k, h in other.items():
            mine = out._h.get(k)
            out._h[k] = h.copy() if mine is None else mine.merge(h)
        return out

    def update(self, other: "HistogramSet") -> None:
        """In-place fold (``self = self.merge(other)`` without the copy)."""
        for k, h in other.items():
            mine = self._h.get(k)
            self._h[k] = h.copy() if mine is None else mine.merge(h)

    def clear(self) -> None:
        self._h.clear()

    def delta_since(self, before: "HistogramSet") -> "HistogramSet":
        """Records added since ``before`` (a prefix snapshot of ``self``).

        Bucket counts and sums subtract exactly; ``min``/``max`` are kept
        from ``self`` (a snapshot cannot un-see an extremum).
        """
        if not before:
            return self.copy()
        out = HistogramSet()
        for k, h in self._h.items():
            b = before.get(k)
            if b is None:
                out._h[k] = h.copy()
                continue
            if h.count == b.count:
                continue
            d = Histogram(
                counts=[a - x for a, x in zip(h.counts, b.counts)],
                count=h.count - b.count,
                sum_ns=h.sum_ns - b.sum_ns,
                min_ns=h.min_ns,
                max_ns=h.max_ns,
            )
            out._h[k] = d
        return out

    def as_dict(self) -> dict:
        """JSON-friendly view: ``"name|kind" -> histogram dict`` (sorted)."""
        return {"|".join(k): h.as_dict()
                for k, h in sorted(self._h.items())}

    def __getstate__(self):
        return self._h

    def __setstate__(self, state):
        self._h = state
