"""Cross-replica metric aggregation: merge N registry snapshots into
one fleet view.

Counterpart of the JAX package's ``telemetry/fleet.py``, line for line:
the same merges, the same refusals, the same JSON.

One serve replica's :meth:`MetricsRegistry.snapshot` answers "what did
THIS process do"; a replicated fleet needs the same
answer across processes, and the merge must not lie:

* **counters** are summed series-wise - total requests across the
  fleet is the sum of per-replica totals, exactly (same float
  addition a single registry would have performed);
* **histogram buckets** are summed bucket-wise against their
  serialized ``bucket_bounds`` (never re-derived from formatted
  keys), so quantiles of the merged view are EXACTLY the quantiles
  the registry would report for the union observation stream - the
  same :func:`registry.quantile_from_buckets` interpolation over the
  summed cumulative counts;
* **gauges** are point-in-time per-process readings that do NOT sum
  (two replicas' queue depths are two facts, not one); each replica's
  gauge series keeps its identity under an added ``replica`` label.

The algebra is **pure** (inputs never mutated) and **associative**:
``merge_two(merge_two(a, b), c) == merge_two(a, merge_two(b, c))`` for
lifted snapshots, so a fleet-of-fleets rollup (scrape aggregators,
then aggregate the aggregators) reports the same numbers as one flat
merge.  :func:`merge_snapshots` is the convenience entry point a fleet
scraper drives against live ``/snapshot`` endpoints.

Plain-Python host-side code: no device values.
"""
from __future__ import annotations

from typing import Any, Dict, List, Mapping, Tuple

from .registry import PERCENTILES, _format_value, quantile_from_buckets

__all__ = ["lift", "merge_snapshots", "merge_two"]


def _label_key(labels: Mapping[str, str]) -> Tuple:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def lift(snapshot: Mapping[str, dict], replica: str) -> Dict[str, dict]:
    """Tag one replica's snapshot for merging: every gauge series gains
    a ``replica`` label (series already carrying one - an upstream
    aggregate - pass through unchanged, which is what makes repeated
    lifting harmless).  Counters and histograms are copied verbatim:
    their merge is a sum, which needs no provenance.  Pure: the input
    snapshot is never mutated."""
    replica = str(replica)
    out: Dict[str, dict] = {}
    for name, entry in snapshot.items():
        new = {k: v for k, v in entry.items() if k != "series"}
        series = [dict(s) for s in entry.get("series", ())]
        if entry.get("kind") == "gauge":
            for s in series:
                labels = dict(s.get("labels", {}))
                labels.setdefault("replica", replica)
                s["labels"] = labels
            names = list(new.get("labelnames",
                                 _series_labelnames(series)))
            if "replica" not in names:
                names.append("replica")
            new["labelnames"] = names
        out[name] = {**new, "series": series}
    return out


def _series_labelnames(series: List[dict]) -> List[str]:
    for s in series:
        return sorted(s.get("labels", {}))
    return []


def merge_two(a: Mapping[str, dict],
              b: Mapping[str, dict]) -> Dict[str, dict]:
    """Merge two LIFTED snapshots (see :func:`lift`).  Pure and
    associative; raises ``ValueError`` on a metric registered with
    different kinds or different histogram bucket bounds across the
    inputs - the fleet must never silently mix incompatible series."""
    out: Dict[str, dict] = {}
    for name in sorted(set(a) | set(b)):
        ea, eb = a.get(name), b.get(name)
        if ea is None or eb is None:
            src = ea if ea is not None else eb
            out[name] = _copy_entry(src)
            continue
        if ea.get("kind") != eb.get("kind"):
            raise ValueError(
                f"metric {name!r} has kind {ea.get('kind')!r} on one "
                f"replica and {eb.get('kind')!r} on another - refusing "
                f"to merge")
        kind = ea.get("kind")
        if kind == "counter":
            out[name] = _merge_summed(name, ea, eb)
        elif kind == "gauge":
            out[name] = _merge_gauges(name, ea, eb)
        elif kind == "histogram":
            out[name] = _merge_histograms(name, ea, eb)
        else:
            raise ValueError(
                f"metric {name!r}: cannot merge kind {kind!r}")
    return out


def merge_snapshots(snapshots: Mapping[str, Mapping[str, dict]]
                    ) -> Dict[str, dict]:
    """Merge ``{replica_name: registry_snapshot}`` into one fleet view.

    Each snapshot is lifted under its replica name, then folded through
    :func:`merge_two` in sorted-replica order (the fold order is
    irrelevant by associativity; sorting just makes the output
    deterministic).  An empty mapping merges to ``{}``.
    """
    merged: Dict[str, dict] = {}
    for replica in sorted(snapshots):
        merged = merge_two(merged, lift(snapshots[replica], replica))
    return merged


# ---------------------------------------------------------------------------
# per-kind series merges

def _copy_entry(entry: Mapping[str, Any]) -> Dict[str, Any]:
    new = {k: v for k, v in entry.items() if k != "series"}
    new["series"] = [dict(s) for s in entry.get("series", ())]
    return new


def _merged_meta(name: str, ea: Mapping, eb: Mapping) -> Dict[str, Any]:
    meta: Dict[str, Any] = {"kind": ea.get("kind"),
                            "help": ea.get("help") or eb.get("help", "")}
    names_a = ea.get("labelnames")
    names_b = eb.get("labelnames")
    if names_a is not None or names_b is not None:
        la, lb = list(names_a or []), list(names_b or [])
        if la and lb and la != lb:
            raise ValueError(
                f"metric {name!r} has labelnames {la} on one replica "
                f"and {lb} on another - refusing to merge")
        meta["labelnames"] = la or lb
    overflow = int(ea.get("label_overflow", 0)) \
        + int(eb.get("label_overflow", 0))
    if overflow:
        meta["label_overflow"] = overflow
    return meta


def _merge_summed(name: str, ea: Mapping, eb: Mapping) -> Dict[str, Any]:
    """Counters: series with the same label set sum their values."""
    acc: Dict[Tuple, Dict[str, Any]] = {}
    for entry in (ea, eb):
        for s in entry.get("series", ()):
            key = _label_key(s.get("labels", {}))
            if key in acc:
                acc[key]["value"] = acc[key]["value"] + s["value"]
            else:
                acc[key] = {"labels": dict(s.get("labels", {})),
                            "value": s["value"]}
    out = _merged_meta(name, ea, eb)
    out["series"] = [acc[k] for k in sorted(acc)]
    return out


def _merge_gauges(name: str, ea: Mapping, eb: Mapping) -> Dict[str, Any]:
    """Gauges: the union of per-replica series.  A label-set collision
    means the same replica was merged in twice - a provenance bug the
    merge refuses to paper over."""
    acc: Dict[Tuple, Dict[str, Any]] = {}
    for entry in (ea, eb):
        for s in entry.get("series", ()):
            key = _label_key(s.get("labels", {}))
            if key in acc:
                raise ValueError(
                    f"gauge {name!r}: duplicate series "
                    f"{dict(s.get('labels', {}))} across merge inputs "
                    f"(same replica merged twice?)")
            acc[key] = dict(s)
    out = _merged_meta(name, ea, eb)
    out["series"] = [acc[k] for k in sorted(acc)]
    return out


def _merge_histograms(name: str, ea: Mapping,
                      eb: Mapping) -> Dict[str, Any]:
    """Histograms: bucket counts sum bucket-wise against identical
    serialized bounds; count and sum add; percentiles are recomputed
    from the MERGED cumulative counts with the registry's own
    interpolation - so merged quantiles equal union-stream quantiles."""
    bounds_a = ea.get("bucket_bounds")
    bounds_b = eb.get("bucket_bounds")
    if bounds_a is None or bounds_b is None:
        raise ValueError(
            f"histogram {name!r}: snapshot carries no bucket_bounds "
            f"(pre-fleet snapshot format?) - cannot merge without "
            f"explicit bucket edges")
    bounds = [float(x) for x in bounds_a]
    if bounds != [float(x) for x in bounds_b]:
        raise ValueError(
            f"histogram {name!r} has bucket bounds {bounds_a} on one "
            f"replica and {bounds_b} on another - refusing to merge "
            f"(summed buckets would be meaningless)")
    keys = [_format_value(b) for b in bounds]
    acc: Dict[Tuple, Dict[str, Any]] = {}
    for entry in (ea, eb):
        for s in entry.get("series", ()):
            key = _label_key(s.get("labels", {}))
            if key in acc:
                tgt = acc[key]
                tgt["buckets"] = {
                    k: tgt["buckets"].get(k, 0) + s["buckets"].get(k, 0)
                    for k in keys}
                tgt["count"] = tgt["count"] + s["count"]
                tgt["sum"] = tgt["sum"] + s["sum"]
            else:
                acc[key] = {"labels": dict(s.get("labels", {})),
                            "buckets": {k: s["buckets"].get(k, 0)
                                        for k in keys},
                            "count": s["count"], "sum": s["sum"]}
    for tgt in acc.values():
        cum = [tgt["buckets"][k] for k in keys]
        tgt["percentiles"] = {
            pname: quantile_from_buckets(bounds, cum, tgt["count"], q)
            for pname, q in PERCENTILES}
    out = _merged_meta(name, ea, eb)
    out["bucket_bounds"] = bounds
    out["series"] = [acc[k] for k in sorted(acc)]
    return out
