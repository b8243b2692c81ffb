"""Request-level metrics (paper §3: response time, prediction time, cost),
with means and 95% confidence intervals as the paper reports.

``summarize`` consumes a plain ``list[RequestRecord]``, the simulator's
columnar ``RecordArray`` sink, or a *folded* ``StreamingRecordArray``
(day-scale streaming runs).  The columnar path never materializes
per-record objects: columns come out of the sink as whole numpy arrays,
the drop-tag filter is proven unnecessary from the sink's distinct-tag
set in the common case, and p50/p95/p99 are computed with a single
``np.percentile(lat, [50, 95, 99])`` call over one latency array.  The
folded path never sees rows at all: the sink folded each consumed chunk
into O(1)-memory running aggregates (counts, sums, squares, extrema) and
``QuantileSketch``es, and ``summarize`` reads the finished summary from
those — p50/p95/p99 come out of the sketch within its accuracy bound
(~<<1% relative on latency-shaped distributions; pinned by fuzz tests)
instead of an exact whole-column percentile.

The port's counterpart of ``repro.core.metrics``: the same arithmetic,
in the same order, on the same explicitly seeded numpy streams, so
that the two give equal results on equal inputs.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

from repro_torch.core.cluster.events import RecordArray


def _ci95(xs) -> float:
    xs = np.asarray(xs, dtype=float)
    if xs.size <= 1:
        return 0.0
    return float(1.96 * xs.std(ddof=1) / math.sqrt(xs.size))


# --------------------------------------------------------------- sketches
class QuantileSketch:
    """Streaming quantile sketch with a guaranteed relative-error bound
    (DDSketch-style log buckets; the chunk-folded sibling of the classic
    P²/t-digest estimators).

    Values land in geometrically spaced buckets ``gamma**k`` with
    ``gamma = (1+alpha)/(1-alpha)``, so the value reported for a bucket is
    within ``alpha`` relative error of every value it holds — a
    *shape-free* guarantee, which matters here: simulated latencies are
    near-atomic bimodal (3% jitter around a warm mode and a cold mode
    ~10x higher), the worst case for centroid-interpolating sketches,
    whose estimates smear across the warm/cold cliff exactly where p95
    tends to sit.  Memory is O(log(max/min) / alpha) occupied buckets —
    a few hundred ints for a day of traffic — independent of stream
    length, which is what lets ``summarize`` report percentiles over a
    10M-row day without ever holding a 10M-element latency column.

    Determinism: bucket counts are exact integers, so the sketch state —
    and every quantile read from it — is identical under any chunking of
    the same value stream.
    """

    __slots__ = ("alpha", "_gamma", "_inv_log_gamma", "_counts", "n",
                 "min", "max", "_zero_n")

    #: values at or below this land in the zero bucket (latencies are
    #: strictly positive; this only guards degenerate inputs)
    _MIN_TRACKABLE = 1e-12

    def __init__(self, alpha: float = 0.001):
        self.alpha = float(alpha)
        self._gamma = (1.0 + alpha) / (1.0 - alpha)
        self._inv_log_gamma = 1.0 / math.log(self._gamma)
        self._counts: dict[int, int] = {}
        self.n = 0
        self._zero_n = 0
        self.min = math.inf
        self.max = -math.inf

    def update(self, values) -> None:
        """Fold one chunk of values into the sketch (vectorized: one log,
        one unique, a dict merge over the chunk's occupied buckets)."""
        v = np.asarray(values, dtype=np.float64).ravel()
        if v.size == 0:
            return
        self.n += int(v.size)
        vmin = float(v.min())
        vmax = float(v.max())
        if vmin < self.min:
            self.min = vmin
        if vmax > self.max:
            self.max = vmax
        pos = v[v > self._MIN_TRACKABLE]
        self._zero_n += int(v.size - pos.size)
        if pos.size:
            idx = np.ceil(np.log(pos) * self._inv_log_gamma).astype(np.int64)
            ks, cs = np.unique(idx, return_counts=True)
            counts = self._counts
            for k, c in zip(ks.tolist(), cs.tolist()):
                counts[k] = counts.get(k, 0) + c

    def quantile(self, q: float) -> float:
        """Estimated ``q``-quantile (q in [0, 1]); exact min/max at the
        ends, a mid-bucket value (relative error <= alpha) between."""
        if self.n == 0:
            return 0.0
        if q <= 0.0:
            return self.min
        if q >= 1.0:
            return self.max
        rank = q * (self.n - 1)
        est = 0.0
        if rank >= self._zero_n:
            cum = self._zero_n
            g = self._gamma
            for k in sorted(self._counts):
                cum += self._counts[k]
                if cum > rank:
                    est = 2.0 * g ** k / (g + 1.0)
                    break
        if est < self.min:
            return self.min
        if est > self.max:
            return self.max
        return est

    def percentile(self, ps) -> list:
        """np.percentile-shaped convenience: ``ps`` in [0, 100]."""
        return [self.quantile(p / 100.0) for p in ps]


class _FoldGroup:
    """Running aggregates for one selection of records (kept / warm / cold):
    everything a ``Summary`` needs, in O(1) memory — counts, moment sums
    for means and CIs, the max, and a latency ``QuantileSketch``."""

    __slots__ = ("n", "n_cold", "lat_sum", "lat_sumsq", "pred_sum",
                 "pred_sumsq", "cost_sum", "lat_max", "sketch", "ok_n",
                 "attempts_sum", "hedge_sum")

    def __init__(self, alpha: float = 0.001):
        self.n = 0
        self.n_cold = 0
        self.lat_sum = 0.0
        self.lat_sumsq = 0.0
        self.pred_sum = 0.0
        self.pred_sumsq = 0.0
        self.cost_sum = 0.0
        self.lat_max = -math.inf
        self.sketch = QuantileSketch(alpha)
        # reliability aggregates: fair-weather runs fold ok=None
        # and these stay at their all-ok identities
        self.ok_n = 0
        self.attempts_sum = 0.0
        self.hedge_sum = 0.0

    def fold(self, lat: np.ndarray, pred: np.ndarray, cost: np.ndarray,
             n_cold: int, ok: np.ndarray | None = None,
             attempts: np.ndarray | None = None,
             hedge: np.ndarray | None = None) -> None:
        if lat.size == 0:
            return
        self.n += int(lat.size)
        self.n_cold += int(n_cold)
        self.lat_sum += float(lat.sum())
        self.lat_sumsq += float((lat * lat).sum())
        self.pred_sum += float(pred.sum())
        self.pred_sumsq += float((pred * pred).sum())
        self.cost_sum += float(cost.sum())
        m = float(lat.max())
        if m > self.lat_max:
            self.lat_max = m
        self.sketch.update(lat)
        self.ok_n += int(lat.size) if ok is None else int(ok.sum())
        self.attempts_sum += (float(lat.size) if attempts is None
                              else float(attempts.sum()))
        if hedge is not None:
            self.hedge_sum += float(hedge.sum())

    @staticmethod
    def _ci95_from_moments(n: int, s: float, ss: float) -> float:
        if n <= 1:
            return 0.0
        var = (ss - s * s / n) / (n - 1)
        if var < 0.0:          # float cancellation on near-constant data
            var = 0.0
        return 1.96 * math.sqrt(var) / math.sqrt(n)

    def summary(self) -> Summary:
        n = self.n
        if n == 0:
            return Summary(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
        p50, p95, p99 = self.sketch.percentile([50, 95, 99])
        return Summary(
            n=n, n_cold=self.n_cold,
            mean_response_s=self.lat_sum / n,
            ci95_response_s=self._ci95_from_moments(n, self.lat_sum,
                                                    self.lat_sumsq),
            mean_prediction_s=self.pred_sum / n,
            ci95_prediction_s=self._ci95_from_moments(n, self.pred_sum,
                                                      self.pred_sumsq),
            p50_s=p50, p95_s=p95, p99_s=p99, max_s=self.lat_max,
            total_cost=self.cost_sum, mean_cost=self.cost_sum / n,
            n_failed=n - self.ok_n, availability=self.ok_n / n,
            mean_attempts=self.attempts_sum / n,
            hedge_cost=self.hedge_sum)


class RecordFold:
    """Running metrics state for a record stream consumed chunk-at-a-time.

    A streaming sink (``StreamingRecordArray`` in fold/spill mode) calls
    ``fold_chunk`` on each full ``RecordArray`` chunk before discarding the
    rows; afterwards ``summarize`` / ``sla.evaluate`` /
    ``phase_breakdown`` / ``container_seconds`` read their reports straight
    from this state.  Memory is O(sketch buckets + distinct containers),
    independent of how many requests streamed through.

    The tag filter is applied *at fold time* (rows are gone afterwards), so
    the fold's ``drop_tags`` must match what the report would have asked
    for — ``summarize`` raises on a mismatch rather than silently serving
    a differently-filtered summary.
    """

    _PHASES = ("provision_s", "bootstrap_s", "load_s", "restore_s")

    __slots__ = ("drop_tags", "kept", "warm", "cold", "all_n", "all_ok_n",
                 "all_sketch", "phase_n", "phase_sums", "by_kind",
                 "container_spans")

    def __init__(self, drop_tags: tuple = ("prime",),
                 alpha: float = 0.001):
        self.drop_tags = tuple(drop_tags)
        self.kept = _FoldGroup(alpha)
        self.warm = _FoldGroup(alpha)
        self.cold = _FoldGroup(alpha)
        # the unfiltered view (SLA evaluation does not drop tags)
        self.all_n = 0
        self.all_ok_n = 0
        self.all_sketch = QuantileSketch(alpha)
        self.phase_n = 0
        self.phase_sums = dict.fromkeys(self._PHASES, 0.0)
        self.by_kind: dict[str, int] = {}
        self.container_spans: dict = {}   # cid -> [first_arrival, last_end]

    def fold_chunk(self, chunk: RecordArray) -> None:
        if not len(chunk):
            return
        cold = chunk.column("cold").astype(bool)
        lat = chunk.response_s()
        pred = chunk.column("prediction_s")
        cost = chunk.column("cost")
        ok = chunk.column("ok").astype(bool)
        attempts = chunk.column("attempts")
        hedge = chunk.column("hedge_cost")
        self.all_n += len(chunk)
        self.all_ok_n += int(ok.sum())
        self.all_sketch.update(lat)

        sel = chunk.keep_mask(self.drop_tags)
        if sel is None:
            klat, kpred, kcost, kcold = lat, pred, cost, cold
            kok, katt, khdg = ok, attempts, hedge
        else:
            klat, kpred, kcost, kcold = lat[sel], pred[sel], cost[sel], \
                cold[sel]
            kok, katt, khdg = ok[sel], attempts[sel], hedge[sel]
        n_cold = int(kcold.sum())
        self.kept.fold(klat, kpred, kcost, n_cold, kok, katt, khdg)
        warm_m = ~kcold
        self.warm.fold(klat[warm_m], kpred[warm_m], kcost[warm_m], 0,
                       kok[warm_m], katt[warm_m], khdg[warm_m])
        self.cold.fold(klat[kcold], kpred[kcold], kcost[kcold], n_cold,
                       kok[kcold], katt[kcold], khdg[kcold])

        # phase-resolved setup sums (cold starts + pool claims, kept tags)
        kinds = chunk.column("cold_kind")
        pmask = cold | (kinds != "")
        if sel is not None:
            pmask &= sel
        pn = int(pmask.sum())
        if pn:
            self.phase_n += pn
            sums = self.phase_sums
            for ph in self._PHASES:
                sums[ph] += float(chunk.column(ph)[pmask].sum())
            by_kind = self.by_kind
            for k in kinds[pmask]:
                k = k or "full"
                by_kind[k] = by_kind.get(k, 0) + 1

        # per-container first-arrival / last-end spans (container_seconds)
        cids = chunk.column("container_id")
        arrs = chunk.column("arrival_s")
        ends = chunk.column("end_s")
        order = np.argsort(cids, kind="stable")
        scids = cids[order]
        cuts = np.flatnonzero(scids[1:] != scids[:-1]) + 1
        starts = np.concatenate([[0], cuts])
        mins = np.minimum.reduceat(arrs[order], starts)
        maxs = np.maximum.reduceat(ends[order], starts)
        spans = self.container_spans
        for cid, a, e in zip(scids[starts], mins, maxs):
            old = spans.get(cid)
            if old is None:
                spans[cid] = [a, e]
            else:
                if a < old[0]:
                    old[0] = a
                if e > old[1]:
                    old[1] = e


def _fold_of(records):
    """The ``RecordFold`` behind ``records``, if it is a folded streaming
    sink (rows consumed; only aggregates remain)."""
    return getattr(records, "fold", None)


@dataclasses.dataclass
class Summary:
    n: int
    n_cold: int
    mean_response_s: float
    ci95_response_s: float
    mean_prediction_s: float
    ci95_prediction_s: float
    p50_s: float
    p95_s: float
    p99_s: float
    max_s: float
    total_cost: float
    mean_cost: float
    # reliability aggregates — identities on fault-free runs, so
    # every pre-existing positional construction stays valid
    n_failed: int = 0
    availability: float = 1.0
    mean_attempts: float = 1.0
    hedge_cost: float = 0.0

    def row(self) -> dict:
        return dataclasses.asdict(self)


def summarize(records, *, warm_only: bool = False, cold_only: bool = False,
              drop_tags: tuple = ("prime",)) -> Summary:
    fold = _fold_of(records)
    if fold is not None:
        if tuple(drop_tags) != fold.drop_tags:
            raise ValueError(
                f"folded sink was aggregated with drop_tags="
                f"{fold.drop_tags}; cannot re-filter consumed records "
                f"with drop_tags={tuple(drop_tags)}")
        if warm_only and cold_only:
            return Summary(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
        group = fold.warm if warm_only else fold.cold if cold_only \
            else fold.kept
        return group.summary()
    if isinstance(records, RecordArray):
        cold = records.column("cold").astype(bool)
        sel = records.keep_mask(drop_tags)
        # both flags compose like the list path's sequential filters
        # (warm_only AND cold_only selects nothing)
        if warm_only:
            sel = ~cold if sel is None else (sel & ~cold)
        if cold_only:
            sel = cold if sel is None else (sel & cold)
        lat = records.response_s()
        pred = records.column("prediction_s")
        cost = records.column("cost")
        ok = records.column("ok").astype(bool)
        attempts = records.column("attempts")
        hedge = records.column("hedge_cost")
        if sel is not None:
            lat, pred, cost, cold = lat[sel], pred[sel], cost[sel], cold[sel]
            ok, attempts, hedge = ok[sel], attempts[sel], hedge[sel]
        n = int(lat.size)
        n_cold = int(cold.sum())
    else:
        rs = [r for r in records if r.tag not in drop_tags]
        if warm_only:
            rs = [r for r in rs if not r.cold]
        if cold_only:
            rs = [r for r in rs if r.cold]
        n = len(rs)
        n_cold = sum(r.cold for r in rs)
        lat = np.array([r.response_s for r in rs])
        pred = np.array([r.prediction_s for r in rs])
        cost = np.array([r.cost for r in rs])
        ok = np.array([r.ok for r in rs], dtype=bool)
        attempts = np.array([r.attempts for r in rs], dtype=float)
        hedge = np.array([r.hedge_cost for r in rs])
    if n == 0:
        return Summary(0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0)
    p50, p95, p99 = np.percentile(lat, [50, 95, 99])
    return Summary(
        n=n, n_cold=n_cold,
        mean_response_s=float(lat.mean()), ci95_response_s=_ci95(lat),
        mean_prediction_s=float(pred.mean()), ci95_prediction_s=_ci95(pred),
        p50_s=float(p50), p95_s=float(p95), p99_s=float(p99),
        max_s=float(lat.max()),
        total_cost=float(cost.sum()), mean_cost=float(cost.mean()),
        n_failed=n - int(ok.sum()), availability=float(ok.sum()) / n,
        mean_attempts=float(attempts.mean()),
        hedge_cost=float(hedge.sum()))


def phase_breakdown(records, *, drop_tags: tuple = ("prime",)) -> dict:
    """Phase-resolved cold-start summary (paper C1/C4, now decomposed).

    Means are over requests that paid any setup — cold starts plus
    bare-pool prewarm starts (``cold_kind="pool"``, which are not colds
    but do pay LOAD); the ``by_kind`` counts classify each by the path it
    took (``full`` / ``pool`` / ``restore`` / ``cache``).
    ``mean_setup_s`` is the mean total setup penalty, i.e. the sum of the
    per-phase means.
    """
    empty = {"n_cold": 0, "provision_s": 0.0, "bootstrap_s": 0.0,
             "load_s": 0.0, "restore_s": 0.0, "mean_setup_s": 0.0,
             "by_kind": {}}
    fold = _fold_of(records)
    if fold is not None:
        if tuple(drop_tags) != fold.drop_tags:
            raise ValueError(
                f"folded sink was aggregated with drop_tags="
                f"{fold.drop_tags}; got drop_tags={tuple(drop_tags)}")
        n = fold.phase_n
        if n == 0:
            return empty
        out = {"n_cold": n}
        for ph in RecordFold._PHASES:
            out[ph] = fold.phase_sums[ph] / n
        out["mean_setup_s"] = sum(out[ph] for ph in RecordFold._PHASES)
        out["by_kind"] = dict(fold.by_kind)
        return out
    if isinstance(records, RecordArray):
        # columnar path: whole-array masks and sums, no per-record views
        cold = records.column("cold").astype(bool)
        kinds = records.column("cold_kind")
        mask = cold | (kinds != "")
        sel = records.keep_mask(drop_tags)
        if sel is not None:
            mask &= sel
        n = int(mask.sum())
        if n == 0:
            return empty
        out = {"n_cold": n}
        for ph in ("provision_s", "bootstrap_s", "load_s", "restore_s"):
            out[ph] = float(records.column(ph)[mask].sum()) / n
        out["mean_setup_s"] = (out["provision_s"] + out["bootstrap_s"]
                               + out["load_s"] + out["restore_s"])
        by_kind: dict[str, int] = {}
        for k in kinds[mask]:
            k = k or "full"
            by_kind[k] = by_kind.get(k, 0) + 1
        out["by_kind"] = by_kind
        return out
    colds = [r for r in records if (r.cold or r.cold_kind)
             and r.tag not in drop_tags]
    if not colds:
        return empty
    n = len(colds)
    out = {"n_cold": n}
    for ph in ("provision_s", "bootstrap_s", "load_s", "restore_s"):
        out[ph] = sum(getattr(r, ph) for r in colds) / n
    out["mean_setup_s"] = (out["provision_s"] + out["bootstrap_s"]
                           + out["load_s"] + out["restore_s"])
    by_kind: dict[str, int] = {}
    for r in colds:
        by_kind[r.cold_kind or "full"] = by_kind.get(r.cold_kind or "full",
                                                     0) + 1
    out["by_kind"] = by_kind
    return out


def container_seconds(records, keepalive_s: float) -> float:
    """Platform-side resource usage: busy time + idle keep-alive tails —
    the provider-cost side of the keep-warm trade-off (paper §5).

    Per container the charge is ``(last end - first arrival) + keepalive``;
    the columnar path computes the spans with one sort + grouped reduce,
    and the folded path reads spans the sink maintained as chunks streamed
    through.
    """
    fold = _fold_of(records)
    if fold is not None:
        return sum((e - a) + keepalive_s
                   for a, e in fold.container_spans.values())
    if isinstance(records, RecordArray):
        if not len(records):
            return 0.0
        cids = records.column("container_id")
        arrs = records.column("arrival_s")
        ends = records.column("end_s")
        order = np.argsort(cids, kind="stable")
        scids = cids[order]
        cuts = np.flatnonzero(scids[1:] != scids[:-1]) + 1
        starts = np.concatenate([[0], cuts])
        firsts = np.minimum.reduceat(arrs[order], starts)
        lasts = np.maximum.reduceat(ends[order], starts)
        return float((lasts - firsts).sum()) + keepalive_s * len(starts)
    by_container: dict[int, list] = {}
    for r in records:
        by_container.setdefault(r.container_id, []).append(r)
    total = 0.0
    for rs in by_container.values():
        first = min(r.arrival_s for r in rs)
        last = max(r.end_s for r in rs)
        total += (last - first) + keepalive_s
    return total
