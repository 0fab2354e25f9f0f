"""Causal request tracing for the serve tier: span trees per request.

Counterpart of the JAX package's ``telemetry/tracing.py``, line for
line: the same ids, W3C ``traceparent`` text and refusals, the same
``span`` events and forest analysis.

The per-solve telemetry stack (flight recorder, phasetrace, comm cost)
answers "what happened inside THIS solve" - but a serve request's life
is longer than its solve: admission -> queue -> shed/defer -> DRR
dispatch -> batched solve -> retry -> breaker -> migration, scattered
across seven uncorrelated event types.  This module stitches them into
one causal tree per request:

* every ``SolverService.submit`` mints a ``trace_id`` (32 hex chars)
  and a root ``submit`` span;
* every decision along the way appends a typed child span
  (``admission``, ``queue_wait``, ``sched``, ``solve``, ``retry``,
  ``migration``, ``result``) carrying ``span_id`` / ``parent_span_id``;
* ``solve`` spans carry the real ``solve_id`` of the batch dispatch,
  so one trace joins the request view to the full solve-level
  telemetry already keyed by that id.

Spans ride the existing event stream as ``"span"`` events (schema'd in
``EVENT_SCHEMA``, rotated, validated) - there is no
second sink.  Each span also carries a W3C-traceparent-shaped context
string (``00-{trace_id}-{span_id}-01``) so a future HTTP/gRPC shim can
inject/extract propagation context unchanged.

Everything here is host-side bookkeeping on plain Python scalars:
no device values, and when no event sink is configured
``RequestTrace.span`` degenerates to an id increment - tracing off, a
solve runs the same operations on the same bits.
"""
from __future__ import annotations

import itertools
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

from . import events

__all__ = [
    "RequestTrace",
    "SPAN_NAMES",
    "build_forest",
    "format_traceparent",
    "new_span_id",
    "new_trace_id",
    "orphan_spans",
    "parse_traceparent",
    "render_tree",
    "span_events",
]

#: the typed span vocabulary - validate_trace.py rejects anything else
#: ("net" = the data-plane hop that carried a submit over HTTP:
#: serve.net hands its receive/parse timing to submit(net_hop=...))
SPAN_NAMES = ("submit", "net", "admission", "queue_wait", "sched",
              "solve", "retry", "migration", "result")

# id generation: W3C trace-context wants 16 random bytes / 8 random
# bytes rendered lowercase-hex.  A per-process random prefix (from
# os.urandom, once) + a monotonic counter gives collision-free ids
# without consuming entropy per span and without Date-like
# nondeterminism inside the hot path.
_PREFIX = os.urandom(8).hex()                  # 16 hex chars
_TRACE_COUNTER = itertools.count(1)
_SPAN_COUNTER = itertools.count(1)


def new_trace_id() -> str:
    """A 32-lowercase-hex W3C trace id, unique within the process."""
    return f"{_PREFIX}{next(_TRACE_COUNTER) & 0xFFFFFFFFFFFFFFFF:016x}"


def new_span_id() -> str:
    """A 16-lowercase-hex W3C span id, unique within the process."""
    return f"{next(_SPAN_COUNTER) & 0xFFFFFFFFFFFFFFFF:016x}"


def format_traceparent(trace_id: str, span_id: str) -> str:
    """The W3C ``traceparent`` header value for a span context:
    ``version-traceid-spanid-flags`` with version 00 and the sampled
    flag set (a span only exists because the sink sampled it)."""
    return f"00-{trace_id}-{span_id}-01"


def parse_traceparent(header: str) -> Tuple[str, str]:
    """Parse a ``traceparent`` value back to ``(trace_id, span_id)``.

    Accepts exactly the shape :func:`format_traceparent` produces
    (version 00, lowercase hex, any flags byte); raises ``ValueError``
    otherwise - the shim boundary should reject malformed context
    loudly, not propagate garbage ids.
    """
    parts = header.split("-")
    if len(parts) != 4:
        raise ValueError(f"traceparent must have 4 '-' separated "
                         f"fields, got {header!r}")
    version, trace_id, span_id, flags = parts
    if version != "00":
        raise ValueError(f"unsupported traceparent version {version!r}")
    for name, value, width in (("trace_id", trace_id, 32),
                               ("span_id", span_id, 16),
                               ("flags", flags, 2)):
        if len(value) != width or value.strip("0123456789abcdef"):
            raise ValueError(f"traceparent {name} must be {width} "
                             f"lowercase hex chars, got {value!r}")
    if trace_id == "0" * 32 or span_id == "0" * 16:
        raise ValueError("traceparent ids must be non-zero")
    return trace_id, span_id


class RequestTrace:
    """One request's causal span chain, owned by its QueuedRequest.

    Holds the trace id, the root (submit) span id, and ``head`` - the
    most recent span in the causal chain, which the next span parents
    to by default.  ``span()`` emits one ``"span"`` event and advances
    the head; explicit ``parent=`` overrides the chain (e.g. a
    ``sched`` span parenting to its ``queue_wait``, a ``migration``
    span parenting to the root).  Thread-safe: submit-thread spans and
    worker-thread spans interleave under one lock.
    """

    __slots__ = ("trace_id", "root_span_id", "head", "request_id",
                 "_lock")

    def __init__(self, request_id: str,
                 trace_id: Optional[str] = None):
        self.trace_id = trace_id or new_trace_id()
        self.root_span_id: Optional[str] = None
        self.head: Optional[str] = None
        self.request_id = request_id
        self._lock = threading.Lock()

    def traceparent(self) -> str:
        """The propagation context of the current head span."""
        return format_traceparent(self.trace_id,
                                  self.head or "0" * 16)

    def span(self, name: str, *, start_s: float, duration_s: float,
             parent: Optional[str] = None, root: bool = False,
             **fields: Any) -> str:
        """Emit one span and return its span_id (the new head).

        ``root=True`` marks the submit span (parent_span_id None);
        otherwise the parent is ``parent`` if given, else the current
        head.  Extra ``fields`` ride the event (status, decision,
        solve_id, attempt, ...).
        """
        if name not in SPAN_NAMES:
            raise ValueError(f"unknown span name {name!r}; "
                             f"known: {SPAN_NAMES}")
        sid = new_span_id()
        with self._lock:
            parent_id = None if root else (parent or self.head)
            if root:
                self.root_span_id = sid
            self.head = sid
            events.emit(
                "span",
                trace_id=self.trace_id,
                span_id=sid,
                parent_span_id=parent_id,
                name=name,
                request_id=self.request_id,
                start_s=float(start_s),
                duration_s=float(max(duration_s, 0.0)),
                traceparent=format_traceparent(self.trace_id, sid),
                **fields)
        return sid


# ---------------------------------------------------------------------------
# forest analysis (tests and trace validators share one definition of
# "complete")

def span_events(records: Iterable[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """The ``"span"`` events of a parsed JSONL record list."""
    return [e for e in records if e.get("event") == "span"]


def build_forest(records: Iterable[Dict[str, Any]]
                 ) -> Dict[str, Dict[str, Any]]:
    """Group span events into per-trace trees.

    Returns ``{trace_id: {"root": span|None, "spans": {span_id: span},
    "children": {span_id: [span, ...]}}}``.  Purely structural - use
    :func:`orphan_spans` for the completeness verdict.
    """
    forest: Dict[str, Dict[str, Any]] = {}
    for e in span_events(records):
        tree = forest.setdefault(
            e["trace_id"], {"root": None, "spans": {}, "children": {}})
        tree["spans"][e["span_id"]] = e
        parent = e.get("parent_span_id")
        if parent is None:
            tree["root"] = e
        else:
            tree["children"].setdefault(parent, []).append(e)
    return forest


def orphan_spans(records: Iterable[Dict[str, Any]]
                 ) -> List[Dict[str, Any]]:
    """Spans NOT reachable from their trace's root submit span.

    A trace with no root makes every one of its spans an orphan.  The
    empty list is the trace-completeness acceptance: every span of
    every request hangs off the submit that minted its trace.
    """
    orphans: List[Dict[str, Any]] = []
    for tree in build_forest(records).values():
        root = tree["root"]
        if root is None:
            orphans.extend(tree["spans"].values())
            continue
        reached = {root["span_id"]}
        frontier = [root["span_id"]]
        while frontier:
            nxt = frontier.pop()
            for child in tree["children"].get(nxt, ()):
                if child["span_id"] not in reached:
                    reached.add(child["span_id"])
                    frontier.append(child["span_id"])
        orphans.extend(s for sid, s in tree["spans"].items()
                       if sid not in reached)
    return orphans


def render_tree(records: Iterable[Dict[str, Any]], trace_id: str,
                ) -> str:
    """An ASCII rendering of one trace's span tree (README / example
    output), children indented under parents in start order."""
    tree = build_forest(records).get(trace_id)
    if tree is None:
        return f"(no spans for trace {trace_id})"
    t0 = min((s["start_s"] for s in tree["spans"].values()),
             default=0.0)
    lines: List[str] = []

    def walk(span: Dict[str, Any], depth: int) -> None:
        extras = []
        for key in ("status", "decision", "solve_id", "attempt",
                    "reason"):
            if span.get(key) is not None:
                extras.append(f"{key}={span[key]}")
        suffix = f"  [{', '.join(extras)}]" if extras else ""
        lines.append(f"{'  ' * depth}{span['name']:<10} "
                     f"+{(span['start_s'] - t0) * 1e3:8.3f}ms "
                     f"{span['duration_s'] * 1e3:8.3f}ms{suffix}")
        kids = sorted(tree["children"].get(span["span_id"], ()),
                      key=lambda s: (s["start_s"], s["span_id"]))
        for kid in kids:
            walk(kid, depth + 1)

    if tree["root"] is not None:
        walk(tree["root"], 0)
    else:
        lines.append(f"(orphaned trace {trace_id}: no root span)")
    return "\n".join(lines)
