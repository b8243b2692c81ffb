"""Event primitives for the cluster simulator.

The event loop is a single binary heap keyed on ``(time, seq)``: ``seq`` is a
monotonically increasing tie-breaker, so two events at the same timestamp pop
in push order.  This is the exact discipline of the original monolithic
``Simulator.run()`` — preserving it (one shared sequence counter, arrivals
pushed first, completion before expiry at dispatch) is what makes the default
policy stack reproduce the old records bit-for-bit.

Hot-path notes:

  * Event kinds are small integers, not strings — the run loop compares the
    popped kind against per-kind constants a few million times per bench
    run, and ints keep that a pointer-free compare.  The names below are
    the API; nothing may depend on the concrete values.
  * ``RequestRecord`` carries ``slots=True``: a million-record run used to
    spend a measurable slice of its wall time building per-record
    ``__dict__``s.
  * ``RecordArray`` is the columnar (struct-of-arrays) record sink the
    simulator appends plain field tuples into.  It quacks like the
    ``list[RequestRecord]`` it replaces — iteration, indexing, equality —
    materializing ``RequestRecord`` views lazily, while ``column()`` /
    ``response_s()`` hand the metrics layer whole numpy arrays without
    ever constructing a million dataclasses.

The port's counterpart of ``repro.core.cluster.events``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import json as _json

import numpy as np

# event kinds (int-valued; compare against the names, never the values) ----
ARRIVAL = 0        # a workload Request reaches the router
COMPLETE = 1       # a container finishes a request (or batch)
EXPIRE = 2         # keep-alive deadline check for a container
PREWARM_READY = 3  # a predictively-provisioned container warms
FLUSH = 4          # a batching fleet's max_wait deadline
PHASE_DONE = 5     # a container finishes one cold-start phase
REQUEUE = 6        # throttled arrival re-entering the loop
BATCH_RETRY = 7    # throttled formed batch retrying as a unit
FAULT = 8          # an attempt dies (provision fail / crash / timeout)
RETRY = 9          # a failed attempt's backoff expires; redispatch
HEDGE_FIRE = 10    # hedge delay elapsed; fire the speculative duplicate
ATTEMPT_DONE = 11  # an attempt completes; resolve the request


class EventQueue:
    """Min-heap of ``(time, seq, kind, payload)`` with a shared seq counter.

    The run loop reaches into ``_heap`` directly (bound to a local) — the
    push/pop methods remain for every non-hot call site.
    """

    __slots__ = ("_heap", "_seq")

    def __init__(self):
        self._heap: list = []
        self._seq = itertools.count()

    def push(self, t: float, kind: int, payload) -> None:
        heapq.heappush(self._heap, (t, next(self._seq), kind, payload))

    def pop(self):
        return heapq.heappop(self._heap)

    def __len__(self) -> int:
        return len(self._heap)

    def __bool__(self) -> bool:
        return bool(self._heap)


@dataclasses.dataclass(slots=True)
class RequestRecord:
    """One served request — the unit every metric/SLA report consumes.

    ``exec_s`` is the request's billed execution share (for a batch of B the
    batch wall time is amortized B ways); ``prediction_s`` is the wall time
    the model actually ran for (the whole batch for batched requests).

    Requests that paid any setup carry the phase-resolved wall seconds
    (jittered; they sum to ``start_exec_s - arrival_s`` for an uncontended
    start): ``provision_s`` / ``bootstrap_s`` / ``load_s`` / ``restore_s``.
    ``cold_kind`` classifies the start path — ``"full"`` (all phases, the
    only kind under FullCold), ``"restore"`` (snapshot hit: PROVISION +
    RESTORE) and ``"cache"`` (package-cache hit: LOAD skipped) are cold
    starts (``cold=True``); ``"pool"`` (bare-sandbox claim: LOAD only) is
    a PREWARM start in the OpenWhisk taxonomy, so ``cold=False`` even
    though ``load_s > 0``; ``""`` means a fully warm start.

    Reliability fields (appended, defaulted — rows from faultless runs
    are unchanged): ``ok`` is False when the request failed past its
    retry budget (``end_s`` is then the give-up time and ``cost`` the
    dollars burned trying); ``attempts`` counts dispatched attempts
    including the hedge; ``hedge_cost`` is the losing duplicate's bill
    (wasted dollars, already included in ``cost``); ``requeues`` counts
    capacity-throttle requeue rounds the request survived.
    """
    rid: int
    arrival_s: float
    start_exec_s: float
    end_s: float
    cold: bool
    prediction_s: float
    exec_s: float
    cost: float
    container_id: int
    memory_mb: int
    tag: str = ""
    fn: str = ""
    batch_size: int = 1
    cold_kind: str = ""
    provision_s: float = 0.0
    bootstrap_s: float = 0.0
    load_s: float = 0.0
    restore_s: float = 0.0
    ok: bool = True
    attempts: int = 1
    hedge_cost: float = 0.0
    requeues: int = 0

    @property
    def response_s(self) -> float:
        return self.end_s - self.arrival_s


#: RequestRecord field order — the row layout RecordArray stores.
RECORD_FIELDS = tuple(f.name for f in dataclasses.fields(RequestRecord))
_FIELD_INDEX = {name: i for i, name in enumerate(RECORD_FIELDS)}
_TAG_I = _FIELD_INDEX["tag"]
#: fields whose columns are numeric (float-convertible) arrays
_NUMERIC_FIELDS = frozenset(RECORD_FIELDS) - {"tag", "fn", "cold_kind"}


class RecordArray:
    """Columnar record sink behind the ``list[RequestRecord]`` API.

    The simulator appends one plain tuple per served request (field order
    ``RECORD_FIELDS``); consumers that iterate or index get lazily
    materialized ``RequestRecord`` dataclasses, so existing code — record
    digests, SLA evaluation, report filters — reads records exactly as
    before.  Consumers that know about columns (``repro_torch.core.metrics``)
    call ``column()`` / ``response_s()`` and get numpy arrays straight
    from the rows, skipping per-record object construction entirely.

    ``tags_seen`` tracks the distinct ``tag`` values appended so far, so a
    summary can prove "nothing here needs dropping" without scanning a
    million rows.
    """

    __slots__ = ("_rows", "tags_seen", "_colcache")

    def __init__(self, rows: list | None = None):
        self._rows: list = list(rows) if rows else []
        self.tags_seen: set = {r[_TAG_I] for r in self._rows}
        # column cache: name -> (row_count, array); consumers like
        # ``metrics.summarize`` hit the same columns several times per
        # report (full/warm/cold summaries), and rebuilding a
        # million-element array per summary was measurable.  Stale entries
        # are detected by row count (rows are append-only).
        self._colcache: dict = {}

    # ------------------------------------------------------------- sink side
    def append_row(self, row: tuple) -> None:
        self._rows.append(row)
        self.tags_seen.add(row[_TAG_I])

    def append(self, record: RequestRecord) -> None:
        """list-API compat: append a materialized record."""
        self.append_row(dataclasses.astuple(record))

    # ----------------------------------------------------------- list facade
    def __len__(self) -> int:
        return len(self._rows)

    def __bool__(self) -> bool:
        return bool(self._rows)

    def __iter__(self):
        for row in self._rows:
            yield RequestRecord(*row)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [RequestRecord(*row) for row in self._rows[i]]
        return RequestRecord(*self._rows[i])

    def _all_rows(self) -> list:
        """Every row as one list (subclass hook: a chunked sink stitches
        its chunks here; a folded sink raises — its rows are gone)."""
        return self._rows

    def __eq__(self, other) -> bool:
        if isinstance(other, RecordArray):
            return self._all_rows() == other._all_rows()
        if isinstance(other, list):
            rows = self._all_rows()
            return len(rows) == len(other) and \
                all(RequestRecord(*row) == r
                    for row, r in zip(rows, other))
        return NotImplemented

    def __repr__(self) -> str:
        return f"RecordArray(n={len(self._rows)})"

    # --------------------------------------------------------- columnar side
    def column(self, name: str) -> np.ndarray:
        """One field across all records, as a numpy array (float64 for
        numeric fields, object for the string fields).  Built once per
        (column, row count) and cached."""
        n = len(self._rows)
        hit = self._colcache.get(name)
        if hit is not None and hit[0] == n:
            return hit[1]
        i = _FIELD_INDEX[name]
        rows = self._rows
        if name in _NUMERIC_FIELDS:
            col = np.fromiter((row[i] for row in rows), dtype=np.float64,
                              count=n)
        else:
            col = np.array([row[i] for row in rows], dtype=object)
        self._colcache[name] = (n, col)
        return col

    def response_s(self) -> np.ndarray:
        """``end_s - arrival_s`` for every record, vectorized (cached like
        a column)."""
        n = len(self._rows)
        hit = self._colcache.get("response_s")
        if hit is not None and hit[0] == n:
            return hit[1]
        col = self.column("end_s") - self.column("arrival_s")
        self._colcache["response_s"] = (n, col)
        return col

    def keep_mask(self, drop_tags: tuple = ()) -> np.ndarray | None:
        """Boolean keep-mask for ``tag not in drop_tags``, or ``None`` when
        no row carries a dropped tag (the common fast path — proven from
        ``tags_seen`` without scanning)."""
        dropped = self.tags_seen.intersection(drop_tags)
        if not dropped:
            return None
        return np.fromiter((row[_TAG_I] not in drop_tags for row in self._rows),
                           dtype=bool, count=len(self._rows))


class StreamingRecordArray(RecordArray):
    """Bounded-memory record sink: rows accumulate into fixed-size chunks
    and each full chunk is handed off according to ``mode``.

    ``mode="hold"``
        Chunks are retained in memory — the full list/columnar API works
        and results are byte-identical to a monolithic ``RecordArray``.  Exercises the chunk
        plumbing without changing memory behaviour; for small runs.
    ``mode="fold"``
        Each full chunk folds into a ``repro_torch.core.metrics.RecordFold``
        (running counts/sums/extrema plus quantile sketches) and its rows
        are dropped.  Peak memory is one chunk + the fold state, no
        matter how many requests stream through; ``summarize`` /
        ``sla.evaluate`` / ``phase_breakdown`` / ``container_seconds``
        read the folded state via the ``fold`` attribute.  Row access
        (iteration, indexing, columns) raises — the rows are gone.
    ``mode="spill"``
        Like ``fold``, but each chunk is also appended to a JSONL file
        (one JSON array per row, ``RECORD_FIELDS`` order, after a header
        line) before being dropped, so the full record stream survives on
        disk for offline analysis; ``iter_spilled`` reads it back.

    The simulator only ever calls ``append_row`` — the per-append overhead
    over the plain sink is a single length check.  ``finalize()`` (called
    by ``ClusterSimulator.run`` when the sink provides it) folds/spills
    the final partial chunk and closes the spill file.

    The tag filter a folded summary would apply is fixed at fold time via
    ``drop_tags``; ``alpha`` is the quantile sketches' relative-error
    bound.
    """

    __slots__ = ("chunk_size", "mode", "fold", "_chunks", "_flushed",
                 "spill_path", "_spill_fh")

    def __init__(self, chunk_size: int = 65536, mode: str = "hold", *,
                 spill_path=None, drop_tags: tuple = ("prime",),
                 alpha: float = 0.001):
        super().__init__()
        if mode not in ("hold", "fold", "spill"):
            raise ValueError(f"unknown streaming mode {mode!r}")
        if chunk_size < 1:
            raise ValueError("chunk_size must be >= 1")
        if mode == "spill" and spill_path is None:
            raise ValueError("mode='spill' needs spill_path=")
        self.chunk_size = int(chunk_size)
        self.mode = mode
        self._chunks: list = []      # hold mode: flushed chunks, in order
        self._flushed = 0            # rows flushed out of the current chunk
        self.spill_path = spill_path
        self._spill_fh = None
        if mode == "hold":
            self.fold = None
        else:
            from repro_torch.core.metrics import RecordFold   # events<->metrics
            self.fold = RecordFold(drop_tags=drop_tags, alpha=alpha)
            if mode == "spill":
                self._spill_fh = open(spill_path, "w")
                self._spill_fh.write(_json.dumps(
                    {"record_fields": list(RECORD_FIELDS)}) + "\n")

    # ------------------------------------------------------------- sink side
    def append_row(self, row: tuple) -> None:
        rows = self._rows
        rows.append(row)
        self.tags_seen.add(row[_TAG_I])
        if len(rows) >= self.chunk_size:
            self._flush_chunk()

    def _flush_chunk(self) -> None:
        rows = self._rows
        if not rows:
            return
        self._flushed += len(rows)
        if self.mode == "hold":
            self._chunks.append(rows)
        else:
            if self._spill_fh is not None:
                write = self._spill_fh.write
                for row in rows:
                    write(_json.dumps(list(row)) + "\n")
            self.fold.fold_chunk(RecordArray(rows))
        self._rows = []

    def finalize(self) -> None:
        """Fold/spill the final partial chunk; idempotent."""
        if self.mode != "hold":
            self._flush_chunk()
        if self._spill_fh is not None:
            self._spill_fh.close()
            self._spill_fh = None

    # ----------------------------------------------------------- list facade
    def _all_rows(self) -> list:
        if self.mode != "hold":
            raise RuntimeError(
                f"rows were consumed (mode={self.mode!r}); read metrics "
                f"from the folded state via .fold")
        out: list = []
        for chunk in self._chunks:
            out.extend(chunk)
        out.extend(self._rows)
        return out

    def __len__(self) -> int:
        return self._flushed + len(self._rows)

    def __bool__(self) -> bool:
        return bool(self._flushed or self._rows)

    def __iter__(self):
        if self.mode != "hold":
            return iter(self._all_rows())    # raises with the mode message
        return (RequestRecord(*row) for row in self._iter_rows())

    def _iter_rows(self):
        for chunk in self._chunks:
            yield from chunk
        yield from self._rows

    def __getitem__(self, i):
        if self.mode != "hold":
            self._all_rows()                 # raises with the mode message
        if isinstance(i, slice):
            return [RequestRecord(*row) for row in self._all_rows()[i]]
        n = len(self)
        if i < 0:
            i += n
        if not 0 <= i < n:
            raise IndexError(i)
        # every flushed chunk holds exactly chunk_size rows
        ci, off = divmod(i, self.chunk_size)
        if ci < len(self._chunks):
            return RequestRecord(*self._chunks[ci][off])
        return RequestRecord(*self._rows[i - self._flushed])

    def __repr__(self) -> str:
        return (f"StreamingRecordArray(n={len(self)}, mode={self.mode!r}, "
                f"chunk_size={self.chunk_size})")

    # --------------------------------------------------------- columnar side
    def column(self, name: str) -> np.ndarray:
        if self.mode != "hold":
            self._all_rows()                 # raises with the mode message
        n = len(self)
        hit = self._colcache.get(name)
        if hit is not None and hit[0] == n:
            return hit[1]
        i = _FIELD_INDEX[name]
        parts = []
        for chunk in (*self._chunks, self._rows):
            if not chunk:
                continue
            if name in _NUMERIC_FIELDS:
                parts.append(np.fromiter((row[i] for row in chunk),
                                         dtype=np.float64, count=len(chunk)))
            else:
                parts.append(np.array([row[i] for row in chunk],
                                      dtype=object))
        col = (np.concatenate(parts) if parts
               else np.empty(0, dtype=(np.float64 if name in _NUMERIC_FIELDS
                                       else object)))
        self._colcache[name] = (n, col)
        return col

    def response_s(self) -> np.ndarray:
        if self.mode != "hold":
            self._all_rows()                 # raises with the mode message
        n = len(self)
        hit = self._colcache.get("response_s")
        if hit is not None and hit[0] == n:
            return hit[1]
        col = self.column("end_s") - self.column("arrival_s")
        self._colcache["response_s"] = (n, col)
        return col

    def keep_mask(self, drop_tags: tuple = ()) -> np.ndarray | None:
        if self.mode != "hold":
            self._all_rows()                 # raises with the mode message
        dropped = self.tags_seen.intersection(drop_tags)
        if not dropped:
            return None
        return np.fromiter(
            (row[_TAG_I] not in drop_tags for row in self._iter_rows()),
            dtype=bool, count=len(self))


def iter_spilled(path):
    """Yield ``RequestRecord``s back out of a ``mode="spill"`` JSONL file."""
    with open(path) as fh:
        header = _json.loads(fh.readline())
        fields = header.get("record_fields", [])
        if tuple(fields) != RECORD_FIELDS:
            raise ValueError(
                f"spill file {path} has record layout {fields}; this "
                f"build expects {list(RECORD_FIELDS)}")
        for line in fh:
            yield RequestRecord(*_json.loads(line))
