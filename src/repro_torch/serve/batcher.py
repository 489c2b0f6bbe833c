"""Request batching: bucket, pad, coalesce, split.

The paper's economics in serving form: every guest→host crossing pays a
fixed conversion + channel cost, so the server coalesces many single
requests into one padded entry call — one signature plan and one set of
crossings serve the whole batch (see :class:`repro_torch.serve.MixedServer`).

Shape discipline comes from a **bucket ladder**: request batches are padded
up to a fixed set of batch sizes and sequence lengths are rounded up to a
multiple, so the number of distinct entry signatures — and therefore of
per-signature plans and first-signature unit calls — stays small and bounded regardless
of traffic.

Exactness contract: splitting a batched result must be *bit-identical* to
running each request alone.

* Batch padding is exact for any batch-parallel program (every op treats
  axis 0 rows independently — true of the exported model forwards).  Filler
  rows replicate the last request so padded numerics stay in-distribution;
  they are sliced away before results are returned.
* Sequence padding (``seq_multiple > 1``) is exact only for causal
  programs, where position ``t`` never attends past ``t`` — the default
  ``seq_multiple=1`` therefore disables it; opt in for causal models.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
from collections import OrderedDict
from typing import Mapping, Sequence

import numpy as np
import torch

from ..core.convert import Resident
from ..core.opset import AVal, canonical_dtype, torch_dtype


@dataclasses.dataclass(frozen=True)
class BucketLadder:
    """The shape-bucketing policy of a :class:`~repro_torch.serve.MixedServer`.

    ``batch_sizes`` — allowed padded batch sizes, ascending (a batch of
    3 request rows runs as the 4-bucket).  Batches larger than the top
    bucket are split by :class:`~repro_torch.serve.MixedServer` into top-bucket
    chunks (bit-exact for batch-parallel programs, like pad/coalesce/
    split), so adversarial batch sizes can never mint unbounded entry
    signatures.
    ``seq_axis``/``seq_multiple`` — every argument axis ``seq_axis`` whose
    extent equals the request's sequence length (taken from the first
    argument) is rounded up to a multiple of ``seq_multiple`` with
    ``pad_value``; matching output axes are sliced back.  This is an
    *extent-matching heuristic*: with ``seq_multiple > 1``, an output axis
    that coincidentally equals the padded length (e.g. a feature dim the
    same size as the padded sequence) would be sliced too — set
    ``unpad_outputs=False`` and slice outputs yourself if your model has
    such an axis.  The default ``seq_multiple=1`` never pads or slices.
    """

    batch_sizes: tuple[int, ...] = (1, 2, 4, 8)
    seq_axis: int = 1
    seq_multiple: int = 1
    pad_value: float = 0
    unpad_outputs: bool = True

    def __post_init__(self):
        sizes = tuple(sorted(set(int(b) for b in self.batch_sizes)))
        if not sizes or sizes[0] < 1:
            raise ValueError(f"batch_sizes must be positive: {self.batch_sizes}")
        if self.seq_multiple < 1:
            raise ValueError(f"seq_multiple must be >= 1: {self.seq_multiple}")
        if self.seq_axis < 1:
            # axis 0 is the request-row axis; treating it as the sequence
            # would inject phantom rows and corrupt grouping keys
            raise ValueError(f"seq_axis must be >= 1: {self.seq_axis}")
        object.__setattr__(self, "batch_sizes", sizes)

    @property
    def max_batch(self) -> int:
        return self.batch_sizes[-1]

    def batch_bucket(self, rows: int) -> int:
        """Smallest ladder bucket holding ``rows`` (or ``rows`` if above)."""
        for b in self.batch_sizes:
            if rows <= b:
                return b
        return rows

    def padded_seq(self, seq: int) -> int:
        m = self.seq_multiple
        return ((seq + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class Request:
    """One caller's entry arguments, normalized for batching.

    ``rows`` is the leading-axis extent shared by every argument (a caller
    may submit more than one row); ``seq`` is the sequence extent taken
    from the first argument (or None for rank-1 args).
    """

    args: tuple[np.ndarray, ...]
    rows: int
    seq: int | None

    @classmethod
    def of(cls, args: Sequence[np.ndarray], seq_axis: int) -> "Request":
        args = tuple(np.asarray(a) for a in args)
        if not args:
            raise ValueError("empty request")
        rows = args[0].shape[0] if args[0].ndim else None
        for i, a in enumerate(args):
            if a.ndim == 0 or a.shape[0] != rows:
                raise ValueError(
                    f"request arg {i} has leading dim "
                    f"{a.shape[:1] or 'scalar'}, expected {rows} "
                    f"(all args must share the request-row axis 0)"
                )
        seq = args[0].shape[seq_axis] if args[0].ndim > seq_axis else None
        return cls(args=args, rows=rows, seq=seq)


def pad_rows(a: np.ndarray, target: int) -> np.ndarray:
    """Grow axis 0 to ``target`` rows by replicating the last row (filler
    stays in-distribution numerically; callers slice it away afterwards)."""
    if a.shape[0] >= target:
        return a
    return np.concatenate([a, np.repeat(a[-1:], target - a.shape[0], axis=0)], axis=0)


def _pad_seq_axis(a: np.ndarray, axis: int, target: int, pad_value) -> np.ndarray:
    if a.shape[axis] == target:
        return a
    widths = [(0, 0)] * a.ndim
    widths[axis] = (0, target - a.shape[axis])
    return np.pad(a, widths, constant_values=pad_value)


def pad_request(req: Request, ladder: BucketLadder) -> tuple[np.ndarray, ...]:
    """Round the request's sequence axes up to the ladder's multiple."""
    if req.seq is None or ladder.seq_multiple == 1:
        return req.args
    target = ladder.padded_seq(req.seq)
    return tuple(
        _pad_seq_axis(a, ladder.seq_axis, target, ladder.pad_value)
        if a.ndim > ladder.seq_axis and a.shape[ladder.seq_axis] == req.seq
        else a
        for a in req.args
    )


def group_key(req: Request, ladder: BucketLadder) -> tuple:
    """Requests with equal keys may share one batched entry call: identical
    dtypes and identical padded shapes everywhere except the row axis.

    Computed arithmetically (no padded copies) — the dispatcher calls this
    on the hot path for every enqueued request.
    """
    key = []
    for a in req.args:
        shape = list(a.shape[1:])
        if (
            req.seq is not None
            and ladder.seq_multiple > 1
            and a.ndim > ladder.seq_axis
            and a.shape[ladder.seq_axis] == req.seq
        ):
            shape[ladder.seq_axis - 1] = ladder.padded_seq(req.seq)
        key.append((str(a.dtype), tuple(shape)))
    return tuple(key)


@dataclasses.dataclass
class Batch:
    """A coalesced group of requests plus the recipe to split results."""

    args: tuple[np.ndarray, ...]        # padded, stacked entry arguments
    requests: tuple[Request, ...]
    offsets: tuple[int, ...]            # start row of each request
    rows: int                           # real request rows (<= padded rows)
    padded_rows: int
    padded_seq: int | None
    seq_axis: int = 1
    unpad_outputs: bool = True

    def split(self, outs: Sequence[np.ndarray]) -> list[tuple[np.ndarray, ...]]:
        """Un-batch: per request, slice its rows and un-pad sequence axes.

        Sequence axes in outputs are recognized by extent (== the batch's
        padded length; see the :class:`BucketLadder` caveat); disable via
        ``unpad_outputs=False`` on the ladder for models where that extent
        can collide with a non-sequence axis.
        """
        results = []
        for req, start in zip(self.requests, self.offsets):
            per_req = []
            for o in outs:
                o = np.asarray(o)
                r = o[start:start + req.rows] if o.ndim else o
                if (
                    self.unpad_outputs
                    and self.padded_seq is not None
                    and req.seq is not None
                    and req.seq != self.padded_seq
                    and r.ndim > self.seq_axis
                    and r.shape[self.seq_axis] == self.padded_seq
                ):
                    r = np.take(r, range(req.seq), axis=self.seq_axis)
                per_req.append(r)
            results.append(tuple(per_req))
        return results


class SlotMap:
    """Fixed-capacity slot assignment for in-flight decode streams.

    The continuous batcher's physical batch is a persistent array of
    ``capacity`` rows; each live stream owns one slot (row index) from
    admission to retirement.  Freed slots are reusable immediately — the
    very next admission pass can hand them out, so a retired stream never
    occupies a row in any later step.

    Row ``capacity`` is fixed on purpose: fused kernels are only
    bitwise-reproducible at a fixed shape, and within one shape every row
    is a pure function of that row's inputs.  Padding each step to the same
    ``capacity`` therefore makes any stream's tokens independent of its
    batch-mates — the bit-exactness contract of
    :class:`~repro_torch.serve.DecodeScheduler`.

    Not thread-safe; owned by the scheduler's decode loop.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1: {capacity}")
        self._slots: list = [None] * capacity

    @property
    def capacity(self) -> int:
        return len(self._slots)

    @property
    def free(self) -> int:
        return sum(1 for s in self._slots if s is None)

    @property
    def live(self) -> int:
        return len(self._slots) - self.free

    def admit(self, item) -> int:
        """Place ``item`` in the lowest free slot; returns the slot index."""
        for i, s in enumerate(self._slots):
            if s is None:
                self._slots[i] = item
                return i
        raise RuntimeError("SlotMap full")

    def retire(self, slot: int):
        """Free ``slot`` (reusable by the next admit) and return its item."""
        item = self._slots[slot]
        if item is None:
            raise KeyError(f"slot {slot} is already free")
        self._slots[slot] = None
        return item

    def occupied(self) -> list[tuple[int, object]]:
        """Live ``(slot, item)`` pairs in slot order."""
        return [(i, s) for i, s in enumerate(self._slots) if s is not None]


# ---------------------------------------------------------------------------
# paged, growing per-stream decode state (the KV-cache layer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StateSpec:
    """Declarative state contract of a :class:`~repro_torch.serve.DecodeScheduler`.

    The default (no growing arrays) is the fixed-size-row contract of the
    recurrent decode LM: every state array is ``(capacity, ...)`` and is
    scattered/kept whole.  ``growing`` generalizes it to **paged, growing
    per-stream KV state**: it maps a state index (position in the
    ``(logits, *state)`` tuple, 0-based over the state arrays only) to the
    batched array's *context axis* — the axis that holds one row per cache
    position and fills by one each step (axis 0 is always the stream axis,
    so growing axes are ``>= 1``).

    Growing arrays are stored in a :class:`PagePool` of fixed-size pages
    (``page_size`` positions each) with a :class:`BlockTable` per slot, and
    re-materialized to the fixed ``(capacity, max_context, ...)`` padded
    shape before every step call — one entry signature forever, and pages
    are recycled the moment a stream retires.

    ``max_context`` must equal the padded context extent the program was
    exported with (e.g. ``export_attn_decode_lm(max_context=...)``); the
    scheduler validates it against the first prefill's output shapes.
    ``pages`` sizes the pool; the default ``capacity × ceil(max_context /
    page_size)`` can satisfy any admissible load.  Admission is
    conservative: a stream is only admitted when its worst-case page count
    (``ceil((prompt_len + max_new_tokens - 1) / page_size)``) fits beside
    the worst cases of every live stream, so mid-flight growth can never
    fail.

    ``share_prefixes`` enables **copy-on-write prefix sharing**: a newly
    admitted stream whose prompt shares a page-aligned prefix with a live
    or recently-retired stream *of the same prompt length* maps those full
    pages read-only instead of re-storing them (the same-length restriction
    is the exactness contract — cached rows are only guaranteed bitwise
    stable within one prefill signature; see ``docs/serving.md``).  Requires
    a suffix-capable prefill entry on the scheduler
    (``DecodeScheduler(prefill_suffix=...)``).  ``prefix_cache_entries``
    bounds the prefix index: retired streams' page-aligned prefixes stay
    reusable until evicted LRU (one prompt registers ``prompt_len //
    page_size`` entries; retained pages are reclaimed automatically if the
    pool runs short, and are dropped at scheduler close, so the zero-leak
    identity holds at drain).
    """

    growing: Mapping[int, int] = dataclasses.field(default_factory=dict)
    max_context: int | None = None
    page_size: int = 16
    pages: int | None = None
    share_prefixes: bool = False
    prefix_cache_entries: int = 64

    def __post_init__(self):
        growing = dict(self.growing)
        for idx, axis in growing.items():
            if idx < 0:
                raise ValueError(f"growing state index must be >= 0: {idx}")
            if axis < 1:
                raise ValueError(
                    f"growing axis must be >= 1 (axis 0 is the stream axis): "
                    f"state {idx} declared axis {axis}"
                )
        if growing and self.max_context is None:
            raise ValueError("StateSpec with growing arrays needs max_context")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1: {self.page_size}")
        if self.pages is not None and self.pages < 1:
            raise ValueError(f"pages must be >= 1: {self.pages}")
        if self.share_prefixes and not growing:
            raise ValueError(
                "share_prefixes=True needs growing state arrays (prefix "
                "sharing maps KV pages; a fixed-row state has none)")
        if self.prefix_cache_entries < 1:
            raise ValueError(
                f"prefix_cache_entries must be >= 1: {self.prefix_cache_entries}")
        object.__setattr__(self, "growing", growing)

    @property
    def paged(self) -> bool:
        return bool(self.growing)

    def _require_paged(self, what: str) -> None:
        if not self.paged:
            raise ValueError(f"{what} is undefined for a fixed-row StateSpec "
                             f"(no growing arrays declared)")

    @property
    def pages_per_stream(self) -> int:
        """Worst-case pages one stream can hold (a full context)."""
        self._require_paged("pages_per_stream")
        return math.ceil(self.max_context / self.page_size)

    def pages_needed(self, context_len: int) -> int:
        """Pages covering ``context_len`` filled positions."""
        return math.ceil(context_len / self.page_size)

    def pool_pages(self, capacity: int) -> int:
        """Pool size: explicit ``pages`` or the can't-fail default."""
        self._require_paged("pool_pages")
        return self.pages if self.pages is not None else (
            capacity * self.pages_per_stream)


class PagePool:
    """Fixed-size, reference-counted page allocator with leak accounting.

    Pages are just indices into per-array backing buffers (see
    :class:`PagedKVState`); the pool owns which are free.  A page starts at
    refcount 1 when allocated; :meth:`retain` lets several owners — slots
    whose block tables alias a shared prompt prefix, or retained prefix-index
    entries — hold the same physical page, and :meth:`release` only frees it
    when the last reference drops.  ``allocs`` / ``frees`` count *physical*
    events, so the leak identity ``allocs - frees == in_use`` is unchanged by
    sharing; ``refs_outstanding`` must also be 0 at close (zero refcount
    leaks).  These feed the :class:`~repro_torch.serve.DecodeReport` page counters.

    Not thread-safe; owned by the scheduler's decode loop.
    """

    def __init__(self, pages: int, page_size: int):
        if pages < 1 or page_size < 1:
            raise ValueError(
                f"pages and page_size must be >= 1: {pages}, {page_size}")
        self.pages = pages
        self.page_size = page_size
        self._free: list[int] = list(range(pages - 1, -1, -1))
        self._refs: dict[int, int] = {}
        self.allocs = 0
        self.frees = 0
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Physical pages allocated (shared pages count once)."""
        return len(self._refs)

    @property
    def refs_outstanding(self) -> int:
        """Total references held across all live pages (0 = nothing leaked)."""
        return sum(self._refs.values())

    def refcount(self, page: int) -> int:
        """References on ``page`` (0 when free) — refcount > 1 means shared,
        and a writer must copy-on-write before mutating it."""
        return self._refs.get(page, 0)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"PagePool exhausted: all {self.pages} pages in use (size the "
                f"pool for the worst case, or rely on the scheduler's "
                f"conservative admission)"
            )
        page = self._free.pop()
        self._refs[page] = 1
        self.allocs += 1
        self.peak_in_use = max(self.peak_in_use, len(self._refs))
        return page

    def retain(self, page: int) -> None:
        """Add a reference to a live page (a share, not an allocation)."""
        if page not in self._refs:
            raise KeyError(f"page {page} is not allocated")
        self._refs[page] += 1

    def release(self, page: int) -> bool:
        """Drop one reference; the physical page frees when the last drops.

        Returns True when the page was *physically* freed (last reference),
        False when other owners remain — callers keeping per-owner
        accounting (see :class:`PagedKVState`) count only True returns."""
        refs = self._refs.get(page)
        if refs is None:
            raise KeyError(f"page {page} is not allocated")
        if refs > 1:
            self._refs[page] = refs - 1
            return False
        del self._refs[page]
        self._free.append(page)
        self.frees += 1
        return True

    def free(self, page: int) -> None:
        """Alias of :meth:`release` (the pre-refcount name, kept stable)."""
        self.release(page)


class BlockTable:
    """Per-slot page lists: logical context position → physical page.

    Slot ``s``'s position ``p`` lives in page ``pages(s)[p // page_size]``
    at offset ``p % page_size``.  ``release`` hands the whole list back for
    recycling the moment a stream retires.  Entries may *alias*: two slots
    whose streams share a prompt prefix can point at the same physical page
    (the :class:`PagePool` refcount tracks the aliases); ``replace`` swaps
    one entry for a private copy when copy-on-write breaks the alias.

    Not thread-safe; owned by the scheduler's decode loop.
    """

    def __init__(self, capacity: int):
        self._tables: list[list[int]] = [[] for _ in range(capacity)]

    def pages(self, slot: int) -> list[int]:
        return self._tables[slot]

    def append(self, slot: int, page: int) -> None:
        self._tables[slot].append(page)

    def replace(self, slot: int, index: int, page: int) -> None:
        """Point entry ``index`` of ``slot`` at ``page`` (the CoW re-map)."""
        self._tables[slot][index] = page

    def release(self, slot: int) -> list[int]:
        pages, self._tables[slot] = self._tables[slot], []
        return pages


def _host(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor on ``a``'s memory (one host copy first where ``a`` is
    not contiguous or not writable)."""
    return torch.from_numpy(np.require(a, requirements=("C", "W")))


class PagedKVState:
    """Paged storage for the growing state arrays of a decode scheduler.

    One :class:`PagePool` + :class:`BlockTable` pair serves every growing
    array (K and V grow in lockstep, so one page id indexes each array's
    backing buffer).  Backing buffers are allocated lazily from the first
    prefill's output shapes: per growing array, ``(pool.pages, page_size,
    *inner)`` with the declared context axis normalized to the page axis.

    Exactness: :meth:`gather` rebuilds the fixed ``(capacity, max_context,
    ...)`` step input from pages **over a zero template** — positions at or
    beyond a stream's filled prefix read 0.0, exactly what the workload's
    ``pad_to`` produced and its select-writes preserved — so the gathered
    array is bit-identical to the state a solo loop would have threaded
    through (:func:`~repro_torch.serve.decode_reference`).

    **Prefix sharing + copy-on-write** (``StateSpec.share_prefixes``): the
    state keeps a bounded LRU *prefix index* mapping ``(prompt_len,
    token-prefix bytes)`` — page-aligned prefixes only — to the pages that
    already hold those positions' K/V rows.  :meth:`match_and_pin` finds the
    longest indexed prefix of a new prompt and pins its pages (a pool
    reference, so no concurrent eviction can recycle them);
    :meth:`admit` then maps the pinned pages into the new slot's block
    table instead of re-storing their rows.  Shared pages are **read-only
    by refcount**: any write routed through :meth:`_writable_page` — the
    per-step append, or an admit whose shared prefix ends mid-page — first
    copies a page whose refcount exceeds 1 and re-points only the writer's
    table entry (``pages_cow_copied`` counts these).  Because decode only
    ever writes the tail page and shared prefixes are page-aligned, the
    common case performs **zero** copies.

    **Storage.**  The backing buffers are numpy arrays on the host, or, when
    the owner passes a ``device`` to :meth:`ensure_buffers`, torch tensors
    on that device, which :meth:`backing` hands out as
    :class:`~repro_torch.core.convert.Resident` values that cross to a unit
    by reference.  On a device, an admission lands its rows with one copy
    and one scatter per array (rows the prefill kept on the device never
    touch the host), the rows :meth:`append_row` takes are held on
    the host until :meth:`flush` lands them all with one copy and one
    indexed write per array, and :meth:`gather_pages` brings back only the
    pages it reads, or builds its dense array on the device.  Both storages
    hold the same bytes after the same operations.

    Not thread-safe; owned by the scheduler's decode loop.
    """

    def __init__(self, capacity: int, spec: StateSpec,
                 pool: PagePool | None = None):
        if not spec.paged:
            raise ValueError("PagedKVState needs a StateSpec with growing arrays")
        self.capacity = int(capacity)
        self.spec = spec
        if pool is None:
            pool = PagePool(spec.pool_pages(capacity), spec.page_size)
        elif pool.page_size != spec.page_size:
            raise ValueError(
                f"shared PagePool has page_size={pool.page_size} but the "
                f"StateSpec declares page_size={spec.page_size}")
        self.pool = pool
        # per-instance *physical* page accounting: with a shared pool
        # (multi-model serving) the pool's global counters mix every model's
        # traffic, so each state tracks its own allocs/frees.  Pages never
        # alias across PagedKVState instances (block tables and the prefix
        # index are per-instance), so allocs - frees is exactly the pages
        # this instance holds.
        self.page_allocs = 0
        self.page_frees = 0
        self.page_peak_in_use = 0
        self.table = BlockTable(capacity)
        self.lengths = [0] * capacity          # filled context per slot
        self._backing: dict[int, np.ndarray | torch.Tensor] = {}  # idx -> pages
        self.device: torch.device | None = None   # the buffers' device; None: numpy
        # appended rows not yet on the device: (flat position, rows by idx)
        self._pending: list[tuple[int, Mapping[int, np.ndarray]]] = []
        self._dense_shape: dict[int, tuple] = {}    # state idx -> batched shape
        self._dtype: dict[int, np.dtype] = {}
        # prefix index: digest key -> (pages, prefix tokens), LRU-ordered.
        # Every entry holds one pool reference per page, so indexed pages
        # survive their producing stream's retirement (bounded retention);
        # the stored tokens guard against digest collisions on lookup.
        self._prefix: "OrderedDict[tuple, tuple[tuple[int, ...], np.ndarray]]" = (
            OrderedDict())
        self.prefix_hits = 0           # admissions that mapped a shared prefix
        self.prefix_tokens_reused = 0  # positions covered by shared pages
        self.pages_shared = 0          # cumulative shared-page mappings
        self.cow_copies = 0            # copy-on-write page copies
        self.bytes_saved = 0           # page-store bytes avoided by sharing
        self.prefix_evictions = 0      # LRU prefix entries dropped

    # -- lazy buffer setup ---------------------------------------------------

    def ensure_buffers(self, idx: int, batched: np.ndarray | Resident,
                       device: torch.device | None = None) -> None:
        """Size the backing buffer for state ``idx`` from a prefill output
        (a numpy array, or a kept one on the device: its shape and dtype),
        zero-filled: a numpy array, or a tensor on ``device`` (every buffer
        of a state lives in one place)."""
        if idx in self._backing:
            return
        if self._backing and device != self.device:
            raise ValueError(f"state {idx} on {device}, but the other growing "
                             f"arrays live on {self.device}")
        axis = self.spec.growing[idx]
        if len(batched.shape) <= axis:
            raise ValueError(
                f"growing state {idx} declared context axis {axis} but the "
                f"program returned rank-{len(batched.shape)} {batched.shape}"
            )
        if batched.shape[axis] != self.spec.max_context:
            raise ValueError(
                f"growing state {idx} has context extent "
                f"{batched.shape[axis]} on axis {axis}, but the StateSpec "
                f"declares max_context={self.spec.max_context} — export the "
                f"program and the spec with the same padded context"
            )
        inner = tuple(d for i, d in enumerate(batched.shape) if i not in (0, axis))
        shape = (self.pool.pages, self.spec.page_size) + inner
        self.device = device
        self._backing[idx] = (
            np.zeros(shape, batched.dtype) if device is None else
            torch.zeros(shape, dtype=torch_dtype(canonical_dtype(batched.dtype)),
                        device=device))
        self._dense_shape[idx] = tuple(batched.shape)
        self._dtype[idx] = np.dtype(batched.dtype)

    def dense_aval(self, idx: int) -> AVal:
        """The aval of state ``idx`` at its fixed padded batched shape (what
        :meth:`gather` and :meth:`gather_pages` build)."""
        return AVal(self._dense_shape[idx], str(self._dtype[idx]))

    def _ctx_first(self, row: np.ndarray | torch.Tensor, idx: int) -> np.ndarray | torch.Tensor:
        """View one stream's state row with the context axis leading."""
        if isinstance(row, torch.Tensor):
            return row.movedim(self.spec.growing[idx] - 1, 0)
        return np.moveaxis(np.asarray(row), self.spec.growing[idx] - 1, 0)

    def _position_nbytes(self) -> int:
        """Backing bytes one context position occupies across growing arrays."""
        return int(sum(b[0, 0].nbytes for b in self._backing.values()))

    # -- allocation + copy-on-write ------------------------------------------

    def _alloc(self) -> int:
        """Allocate a page, reclaiming retained prefix entries if short.

        Retention must never turn an admissible allocation into a failure:
        pages held only by the prefix index are evicted LRU until the pool
        can serve the request (pages also mapped by live slots survive the
        eviction — only the index's references drop)."""
        while True:
            try:
                page = self.pool.alloc()
                self.page_allocs += 1
                self.page_peak_in_use = max(self.page_peak_in_use,
                                            self.pages_in_use)
                return page
            except RuntimeError:
                if not self._evict_one():
                    raise

    def _release(self, page: int) -> None:
        """Drop one of this instance's references, tracking physical frees."""
        if self.pool.release(page):
            self.page_frees += 1

    @property
    def pages_in_use(self) -> int:
        """Physical pages this instance currently holds in the pool."""
        return self.page_allocs - self.page_frees

    def _writable_page(self, slot: int, index: int) -> int:
        """The page backing entry ``index`` of ``slot``, private to it.

        Copy-on-write: a page with refcount > 1 is aliased by another slot
        or by the prefix index, so the writer gets a fresh copy (all growing
        arrays' buffers — one page id spans them all) and only its own table
        entry is re-pointed; every other reader keeps observing the original
        bytes."""
        page = self.table.pages(slot)[index]
        if self.pool.refcount(page) == 1:
            return page
        fresh = self._alloc()
        self.flush()
        for buf in self._backing.values():
            buf[fresh] = buf[page]              # on a device: device to device
        self.table.replace(slot, index, fresh)
        self._release(page)
        self.cow_copies += 1
        return fresh

    # -- the paged lifecycle -------------------------------------------------

    def admit(
        self,
        slot: int,
        rows: Mapping[int, np.ndarray],
        length: int,
        *,
        shared_len: int = 0,
        shared_pages: Sequence[int] = (),
        pinned: bool = False,
    ) -> None:
        """Store a freshly-prefilled stream: map shared prefix pages, alloc
        the rest, copy the uncached positions.

        Callers run :meth:`ensure_buffers` on the batched prefill outputs
        first (the backing buffers are sized from them).  ``rows`` are
        numpy rows, or, for device storage, rows already on the device (a
        kept prefill output's), copied there without a trip to the host.  ``shared_pages``
        (from :meth:`match_and_pin`) cover positions ``[0, shared_len)`` and
        are mapped read-only; ``pinned=True`` transfers the pin's pool
        references into the block table instead of retaining again.  A
        ``shared_len`` that ends mid-page triggers copy-on-write for the
        boundary page before the suffix rows land in it.
        """
        ps = self.spec.page_size
        assert not self.table.pages(slot), "slot admitted twice"
        if shared_pages:
            if not 0 < shared_len <= length:
                raise ValueError(
                    f"shared_len={shared_len} must be in (0, {length}]")
            if math.ceil(shared_len / ps) != len(shared_pages):
                raise ValueError(
                    f"{len(shared_pages)} shared pages cannot cover "
                    f"shared_len={shared_len} at page_size={ps}")
            for page in shared_pages:
                if not pinned:
                    self.pool.retain(page)
                self.table.append(slot, page)
            self.prefix_hits += 1
            self.pages_shared += len(shared_pages)
            self.prefix_tokens_reused += shared_len
            self.bytes_saved += shared_len * self._position_nbytes()
        for _ in range(len(shared_pages), self.spec.pages_needed(length)):
            self.table.append(slot, self._alloc())
        flat: list[int] = []                    # device: each written position
        for j in range(shared_len // ps, self.spec.pages_needed(length)):
            lo = max(j * ps, shared_len)        # first position to write
            hi = min((j + 1) * ps, length)
            if hi <= lo:
                continue
            page = self._writable_page(slot, j)
            if self.device is not None:
                # the rows, then the last page's zero tail
                end = (j + 1) * ps if hi == length else hi
                flat.extend(range(page * ps + lo - j * ps, page * ps + end - j * ps))
                continue
            for idx, row in rows.items():
                src = self._ctx_first(row, idx)
                buf = self._backing[idx]
                buf[page][lo - j * ps:hi - j * ps] = src[lo:hi]
                if hi == length:
                    buf[page][hi - j * ps:] = 0
        if flat:
            # written positions run from shared_len to length, then zeros;
            # held rows land first, so a page freed and taken again keeps
            # this write, as in order
            self.flush()
            at = torch.from_numpy(np.asarray(flat, np.int64)).to(self.device)
            for idx, row in rows.items():
                buf = self._backing[idx]
                vals = buf.new_zeros((len(flat),) + buf.shape[2:])
                src = self._ctx_first(row, idx)[shared_len:length]
                vals[:length - shared_len].copy_(
                    src if isinstance(src, torch.Tensor) else _host(src))
                self._flat(idx).index_copy_(0, at, vals)
        self.lengths[slot] = length

    def append(self, slot: int, rows: Mapping[int, np.ndarray]) -> None:
        """Append one context position (a step's newly written row).

        Decode writes only the tail page; if that page is shared (possible
        only when a shared prefix ended mid-page), copy-on-write detaches it
        first so no other stream observes the write.
        """
        position = self.lengths[slot]
        if position >= self.spec.max_context:
            raise RuntimeError(
                f"slot {slot} overflowed max_context={self.spec.max_context}")
        self.append_row(slot, {
            idx: self._ctx_first(row, idx)[position]
            for idx, row in rows.items()})

    def append_row(self, slot: int, rows: Mapping[int, np.ndarray]) -> None:
        """Append one context position given *just* that position's values.

        The paged-kernel step root returns the fresh k/v rows directly
        (``(B, inner...)``) instead of a full dense context axis, so the
        scheduler lands them here without materializing — or even holding —
        a ``(max_context, inner...)`` row per stream.  Same page-allocation
        and copy-on-write discipline as :meth:`append`.
        """
        ps = self.spec.page_size
        position = self.lengths[slot]
        if position >= self.spec.max_context:
            raise RuntimeError(
                f"slot {slot} overflowed max_context={self.spec.max_context}")
        if position % ps == 0 and len(self.table.pages(slot)) <= position // ps:
            self.table.append(slot, self._alloc())
        page = self._writable_page(slot, position // ps)
        if self.device is not None:
            self._pending.append((page * ps + position % ps, rows))
        else:
            for idx, row in rows.items():
                self._backing[idx][page][position % ps] = np.asarray(row)
        self.lengths[slot] = position + 1

    def flush(self) -> None:
        """Land the rows :meth:`append_row` holds on the host (device
        storage): one host-to-device copy and one indexed write per growing
        array, whatever the number of rows.  Where a page freed in between
        was taken again, the later row wins, as in order.  Every reader of
        the device buffers flushes first."""
        if not self._pending:
            return
        pending, self._pending = self._pending, []
        flat = np.asarray([p for p, _ in pending], np.int64)
        keep = np.arange(len(flat))
        if np.unique(flat).size < flat.size:
            _, last = np.unique(flat[::-1], return_index=True)
            keep = np.sort(len(flat) - 1 - last)
        at = torch.from_numpy(flat[keep]).to(self.device)
        for idx in pending[0][1]:
            flat_buf = self._flat(idx)
            rows = _host(np.stack([np.asarray(pending[i][1][idx]) for i in keep]))
            flat_buf.index_copy_(0, at, rows.to(self.device, flat_buf.dtype))

    def _flat(self, idx: int) -> torch.Tensor:
        """Device buffer ``idx`` with one row per (page, offset)."""
        buf = self._backing[idx]
        return buf.view((-1,) + tuple(buf.shape[2:]))

    def retire(self, slot: int) -> None:
        """Drop the slot's references; unshared pages recycle immediately.

        Pages also referenced by the prefix index (or by another slot's
        block table) stay live — that is what lets a later stream reuse a
        retired stream's prompt prefix."""
        for page in self.table.release(slot):
            self._release(page)
        self.lengths[slot] = 0

    # -- the prefix index (sharing policy) -----------------------------------

    def prefix_keys(self, prompt: np.ndarray) -> list[tuple[int, tuple]]:
        """``(shared_len, index key)`` per page-aligned prefix, ascending.

        Keys are ``(prompt_len, page_count, running sha256)`` with the
        digest extended page by page — hashing *every* prefix of one prompt
        costs one linear pass over its bytes, not a quadratic re-hash per
        length.  The dtype is folded in so equal values at different widths
        never collide."""
        length = int(prompt.shape[0])
        ps = self.spec.page_size
        digest = hashlib.sha256(str(prompt.dtype).encode())
        keys = []
        for j in range(1, length // ps + 1):
            digest.update(prompt[(j - 1) * ps:j * ps].tobytes())
            keys.append((j * ps, (length, j, digest.digest())))
        return keys

    def match_and_pin(
        self,
        prompt: np.ndarray,
        keys: list[tuple[int, tuple]] | None = None,
    ) -> tuple[int, tuple[int, ...]]:
        """Longest indexed page-aligned prefix of ``prompt``; pins its pages.

        Returns ``(shared_len, pages)`` — ``(0, ())`` when sharing is off or
        nothing matches.  Matching is restricted to prefixes produced at the
        *same prompt length*: one prefill signature means one compiled
        executable, which is what makes the cached rows bitwise equal to the
        rows the new stream's own prefill would have produced.  Candidate
        hits are verified against the entry's stored tokens (a digest
        collision degrades to a miss, never to wrong pages).  The returned
        pages carry one pool reference each (the *pin*), so allocation
        pressure between match and admit can never evict and recycle them;
        pass them to :meth:`admit` with ``pinned=True`` (which adopts the
        references) or return them via :meth:`unpin`.  ``keys`` (from
        :meth:`prefix_keys`) skips re-hashing when the caller already
        computed this prompt's keys for an earlier match attempt.
        """
        if not self.spec.share_prefixes:
            return 0, ()
        prompt = np.asarray(prompt)
        if keys is None:
            keys = self.prefix_keys(prompt)
        for shared_len, key in reversed(keys):
            entry = self._prefix.get(key)
            if entry is None:
                continue
            pages, tokens = entry
            if not np.array_equal(tokens, prompt[:shared_len]):
                continue
            self._prefix.move_to_end(key)
            for page in pages:
                self.pool.retain(page)
            return shared_len, pages
        return 0, ()

    def unpin(self, pages: Sequence[int]) -> None:
        """Return the references :meth:`match_and_pin` took (failure paths)."""
        for page in pages:
            self._release(page)

    def register_prefix(self, slot: int, prompt: np.ndarray) -> None:
        """Publish the slot's page-aligned prompt prefixes for later reuse.

        One index entry per full-page prefix length (each holding pool
        references on its pages), so a later prompt sharing any page-aligned
        amount of this prompt can map it.  The index is LRU-bounded by
        ``StateSpec.prefix_cache_entries`` — note one prompt registers
        ``prompt_len // page_size`` entries; eviction only drops the
        index's references, never a live slot's.
        """
        if not self.spec.share_prefixes:
            return
        prompt = np.asarray(prompt)
        pages = self.table.pages(slot)
        for shared_len, key in self.prefix_keys(prompt):
            if key in self._prefix:
                self._prefix.move_to_end(key)
                continue
            entry = tuple(pages[:key[1]])
            for page in entry:
                self.pool.retain(page)
            self._prefix[key] = (entry, np.array(prompt[:shared_len]))
        while len(self._prefix) > self.spec.prefix_cache_entries:
            self._evict_one()

    def _evict_one(self) -> bool:
        """Drop the least-recently-used prefix entry; True if one existed."""
        if not self._prefix:
            return False
        _, (pages, _tokens) = self._prefix.popitem(last=False)
        for page in pages:
            self._release(page)
        self.prefix_evictions += 1
        return True

    def clear_prefix_index(self) -> None:
        """Release every retained prefix (scheduler close: zero-leak drain)."""
        while self._evict_one():
            pass

    def gather(self, idx: int) -> np.ndarray:
        """Materialize state ``idx`` at its fixed padded batched shape (host
        storage only: the dense step that reads it keeps its pools there)."""
        if self.device is not None:
            raise RuntimeError("gather reads host pools; these live on "
                               f"{self.device}")
        ps = self.spec.page_size
        dense = np.zeros(self._dense_shape[idx], self._dtype[idx])
        buf = self._backing[idx]
        for slot in range(self.capacity):
            dst = self._ctx_first(dense[slot], idx)
            length = self.lengths[slot]
            for j, page in enumerate(self.table.pages(slot)):
                extent = min(ps, length - j * ps)
                if extent > 0:
                    dst[j * ps:j * ps + extent] = buf[page][:extent]
        return dense

    def gather_pages(
        self,
        idx: int,
        row_pages: Sequence[tuple[Sequence[int], int]],
        *,
        resident: bool = False,
    ) -> np.ndarray | Resident:
        """Materialize state ``idx`` from explicit per-row page lists.

        ``row_pages`` gives ``(pages, length)`` per batch row (shorter than
        capacity is fine; missing rows stay zero).  This is the admission
        companion of :meth:`gather`: the suffix-capable prefill consumes the
        *matched prefix* pages of streams that are not in any slot yet, so
        the rows are addressed by pending-batch position, not by slot.
        ``resident`` (device storage only): build it on the device instead,
        a zero tensor with the positions read scattered in by one indexed
        write, and hand it out as a :class:`Resident`.
        """
        ps = self.spec.page_size
        if resident:
            if self.device is None:
                raise RuntimeError("a resident gather needs device pools")
            self.flush()
            buf = self._backing[idx]
            dense = buf.new_zeros(self._dense_shape[idx])
            rows, pos, src = [], [], []         # (batch row, position) <- pool row
            for row, (pages, length) in enumerate(row_pages):
                p = np.arange(length, dtype=np.int64)
                rows.append(np.full(length, row, np.int64))
                pos.append(p)
                src.append(np.asarray(pages, np.int64)[p // ps] * ps + p % ps)
            if sum(map(len, pos)):
                rows, pos, src = (torch.from_numpy(np.concatenate(a)).to(self.device)
                                  for a in (rows, pos, src))
                ctx = dense.movedim(self.spec.growing[idx], 1)
                ctx[rows, pos] = self._flat(idx).index_select(0, src)
            return Resident(dense)
        dense = np.zeros(self._dense_shape[idx], self._dtype[idx])
        reads = [(row, j, page, min(ps, length - j * ps))
                 for row, (pages, length) in enumerate(row_pages)
                 for j, page in enumerate(pages) if length > j * ps]
        if not reads:
            return dense
        buf = self._backing[idx]
        if self.device is not None:
            # only the pages read come back, each once (rows may share
            # them), in one copy
            self.flush()
            ids, at = np.unique(np.asarray([r[2] for r in reads], np.int64),
                                return_inverse=True)
            buf = buf[torch.from_numpy(ids).to(self.device)].cpu().numpy()
        for i, (row, j, page, extent) in enumerate(reads):
            src = buf[at[i]] if self.device is not None else buf[page]
            self._ctx_first(dense[row], idx)[j * ps:j * ps + extent] = src[:extent]
        return dense

    def backing(self, idx: int) -> np.ndarray | Resident:
        """State ``idx``'s pool backing buffer, ``(pages, page_size, inner)``.

        This IS the array the paged-kernel step consumes, instead of a dense
        per-stream gather: the numpy array, or, on a device, the
        :class:`~repro_torch.core.convert.Resident` handle the crossing
        passes to the unit by reference, every appended row landed.
        """
        if self.device is None:
            return self._backing[idx]
        self.flush()
        return Resident(self._backing[idx])

    def table_array(self) -> np.ndarray:
        """Block tables as one dense ``(capacity, pages_per_stream)`` int32.

        Row ``slot``'s first ``ceil(lengths[slot]/page_size)`` entries are
        that stream's physical page ids in logical order; dead entries are
        clamped to page 0 so the kernel's prefetch-driven DMA always reads
        a real page (its contribution is masked out by the live length).
        """
        arr = np.zeros((self.capacity, self.spec.pages_per_stream), np.int32)
        for slot in range(self.capacity):
            pages = self.table.pages(slot)
            if pages:
                arr[slot, :len(pages)] = pages
        return arr

    def lengths_array(self) -> np.ndarray:
        """Live context lengths as a dense ``(capacity,)`` int32 vector."""
        return np.asarray(self.lengths, np.int32)

    def valid_positions(self) -> int:
        """Filled context positions across live slots (cache occupancy)."""
        return sum(self.lengths)


def coalesce(requests: Sequence[Request], ladder: BucketLadder) -> Batch:
    """Stack same-key requests into one padded batch.

    Rows are concatenated in request order, the total is padded up to the
    ladder bucket by replicating the final row, and every sequence axis is
    padded to the group's target; ``Batch.split`` inverts both paddings.
    """
    if not requests:
        raise ValueError("coalesce of zero requests")
    key = group_key(requests[0], ladder)
    for r in requests[1:]:
        if group_key(r, ladder) != key:
            raise ValueError("cannot coalesce requests with different signatures")
    padded = [pad_request(r, ladder) for r in requests]
    offsets, rows = [], 0
    for r in requests:
        offsets.append(rows)
        rows += r.rows
    bucket = ladder.batch_bucket(rows)
    args = [
        pad_rows(np.concatenate([p[i] for p in padded], axis=0), bucket)
        for i in range(len(padded[0]))
    ]
    seqs = [r.seq for r in requests if r.seq is not None]
    padded_seq = ladder.padded_seq(max(seqs)) if seqs else None
    return Batch(
        args=tuple(args),
        requests=tuple(requests),
        offsets=tuple(offsets),
        rows=rows,
        padded_rows=bucket,
        padded_seq=padded_seq,
        seq_axis=ladder.seq_axis,
        unpad_outputs=ladder.unpad_outputs,
    )
