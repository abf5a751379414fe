"""Online per-phase blame attribution (the ``HPNN_BLAME`` knob).

A copy of ``hpnn_tpu/obs/blame.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

``tools/tail_report.py`` answers "which phase of the serving pipeline
is to blame for the tail" — but only offline, over a finished sink.
This module is the same classifier run **in-process**: the shared pure
core (:func:`phase_of` / :func:`split` / :func:`analyze`, which
tail_report now imports instead of duplicating) plus a streaming
engine fed by every emitted span (``spans.finish`` taps
:func:`note_record`).  When a request root closes
(``serve.request`` / ``cluster.request`` — the forensics sampler's
emitted roots, obs/forensics.py), its buffered descendants are
assembled into the same tree the offline tool reconstructs and the
per-phase **exclusive-time** split is folded into a rolling window of
the last ``HPNN_BLAME_WINDOW`` roots:

=============  ====================================================
phase          span names
=============  ====================================================
queue          ``*.queue`` (batcher admission-to-pop wait)
dispatch       ``*dispatch*`` (device forward, coalesced batch)
spill          ``*spill*`` (host spill/reload traffic)
shed_retry     any span that ended ``failed=Shed|QueueFull``
other          any other instrumented descendant
gap            root ``dt`` minus the subtree's covered time
=============  ====================================================

The window publishes rolling ``blame.queue_pct`` /
``blame.dispatch_pct`` / ``blame.spill_pct`` / ``blame.shed_pct``
(plus ``other``/``gap``) fleet-wide gauges on ``/metrics`` — plain
gauges, so the PR 12 alert grammar (obs/alerts.py) rules over them
unchanged — per-kernel rows ride the same gauge names with a
``kernel`` field, ``/healthz`` carries :func:`health_doc`, and a
capture capsule (obs/triggers.py) snapshots :func:`sketch_doc` as
``blame.json``.  The remediation layer (hpnn_tpu_torch/tune/,
docs/selftuning.md) consumes :func:`fleet_doc` as its sensor.

Because the online engine and the offline tool share one core over
one record shape (:func:`normalize_record`), their splits agree on
the same traffic — the agreement test (tests/test_blame.py) holds
them within 1pp per phase, and ``bench.py`` gates the marginal cost
as ``blame_overhead_pct`` (≤5%, like ``sampler_overhead_pct``).

Contract (the usual obs rules, proven by tools/check_tokens.py):
``HPNN_BLAME`` unset ⇒ one env read ever, then every tap is a
constant-time early return; never a stdout byte; stdlib only.
"""

from __future__ import annotations

import collections
import os
import threading

# NOTE: the registry import is deferred to the publish path on
# purpose — the pure classifier core above the online engine must load
# with no package context at all, so tools/tail_report.py can
# file-load this module on a login node where hpnn_tpu_torch's dependencies
# are absent.

ENV_KNOB = "HPNN_BLAME"
ENV_WINDOW = "HPNN_BLAME_WINDOW"

DEFAULT_WINDOW = 128
WINDOW_FLOOR = 16

ROOT_NAMES = ("serve.request", "cluster.request")
PHASES = ("queue", "dispatch", "spill", "shed_retry", "other", "gap")

# rejected-attempt markers (serve/batcher.py raises, spans record the
# exception class in the ``failed`` field)
SHED_FAILS = ("Shed", "QueueFull")

# gauge name per phase: the ISSUE-facing spelling shortens shed_retry
GAUGE_OF = {"queue": "blame.queue_pct", "dispatch": "blame.dispatch_pct",
            "spill": "blame.spill_pct", "shed_retry": "blame.shed_pct",
            "other": "blame.other_pct", "gap": "blame.gap_pct"}

_STRIDE = 8        # roots between gauge publishes (amortizes the
                   # 6-gauge emission so the per-root fold stays a few
                   # dict ops — the overhead bench holds
                   # blame_overhead_pct under the 5% bar)
_PENDING_CAP = 2048   # buffered descendant spans awaiting their root
_KERNELS_CAP = 32     # distinct kernels tracked; the rest fold into
                      # "_other" (same first-K admission the meter's
                      # unarmed governor uses)
_PER_KERNEL_TOP = 4   # kernels that get per-kernel gauge rows

# structural keys of a span.end record; everything else is span fields
_STRUCTURAL = frozenset(("ev", "kind", "span", "parent", "name", "t0",
                         "dt", "ts"))

# None = env not read yet; False = disabled; dict = armed config
_cfg: dict | bool | None = None
_lock = threading.Lock()

_pending: "collections.OrderedDict[int, dict]" = collections.OrderedDict()
_children: dict[int, list[int]] = {}    # parent id -> child ids
_window: collections.deque = collections.deque()  # (kernel, phases)
_tot = {p: 0.0 for p in PHASES}         # running window phase sums
_kern: dict[str, list] = {}             # kernel -> [roots, {phase: s}]
_roots_seen = 0                         # total roots ever folded
_since_pub = 0                          # roots since last gauge publish


# ===================================================== shared pure core
#
# These functions are the single classifier both surfaces run:
# tools/tail_report.py imports them for the offline report, the online
# engine below feeds them one reconstructed tree at a time.  Spans are
# normalized dicts: {"ref", "parent_ref", "name", "dt", "fields"}.

def phase_of(span: dict) -> str:
    """Classify one descendant span into a blame phase by name (the
    shed/retry check wins: a failed dispatch attempt is retry waste,
    not useful device time)."""
    if span["fields"].get("failed") in SHED_FAILS:
        return "shed_retry"
    name = span["name"] or ""
    if name.endswith(".queue") or ".queue" in name:
        return "queue"
    if "dispatch" in name:
        return "dispatch"
    if "spill" in name:
        return "spill"
    return "other"


def normalize_record(rec: dict) -> dict:
    """One raw ``span.end`` record (obs/spans.py shape: ``span`` /
    ``parent`` ids, span fields inline) → the normalized span dict the
    core classifies.  ``tools/obs_report.py collect_spans`` produces
    the same shape from a sink, which is what keeps the online and
    offline splits byte-for-byte comparable."""
    return {
        "ref": rec.get("span"),
        "parent_ref": rec.get("parent"),
        "name": rec.get("name"),
        "dt": float(rec.get("dt") or 0.0),
        "fields": {k: v for k, v in rec.items()
                   if k not in _STRUCTURAL},
    }


def index_children(spans: list[dict]) -> dict:
    """``parent ref -> [child spans]`` over one span set (refs resolved
    within the set; a span whose parent is absent parents nothing)."""
    children_of: dict = {}
    by_ref = {s["ref"]: s for s in spans if s["ref"] is not None}
    for s in spans:
        parent = by_ref.get(s["parent_ref"])
        if parent is not None and parent is not s:
            children_of.setdefault(parent["ref"], []).append(s)
    return children_of


def request_roots(spans: list[dict],
                  root_names=ROOT_NAMES) -> list[dict]:
    """The outermost request spans: named like a request root AND not
    nested under another collected span (a ``serve.request`` under a
    ``cluster.request`` blames into its parent, not the table)."""
    by_ref = {s["ref"]: s for s in spans if s["ref"] is not None}
    return [s for s in spans
            if s["name"] in root_names
            and by_ref.get(s["parent_ref"]) is None]


def _descendants(root: dict, children_of: dict) -> list[dict]:
    out: list[dict] = []
    stack = [root]
    while stack:
        for child in children_of.get(stack.pop()["ref"], ()):
            out.append(child)
            stack.append(child)
    return out


def split(root: dict, children_of: dict) -> dict:
    """The per-phase wall-time split of one request root: exclusive
    descendant time charged per phase, the uncovered remainder as
    ``gap``.  Values in seconds; they sum to ``root['dt']`` up to
    clock skew on remote children (each clamped at 0)."""
    phases = {p: 0.0 for p in PHASES}
    for d in _descendants(root, children_of):
        kids = children_of.get(d["ref"], ())
        exclusive = max(0.0, d["dt"] - sum(c["dt"] for c in kids))
        phases[phase_of(d)] += exclusive
    covered = sum(phases.values())
    phases["gap"] = max(0.0, root["dt"] - covered)
    return phases


def analyze(spans: list[dict], *, top: int = 10,
            root_names=ROOT_NAMES) -> dict:
    """The machine-form report: slowest-N roots with per-phase blame
    plus the aggregate split over every root (the shape
    ``tools/tail_report.py`` renders and ``--json`` dumps)."""
    children_of = index_children(spans)
    roots = request_roots(spans, root_names)
    agg = {p: 0.0 for p in PHASES}
    rows = []
    for root in roots:
        phases = split(root, children_of)
        for p, v in phases.items():
            agg[p] += v
        rows.append({
            "name": root["name"],
            "ref": root["ref"],
            "dt": root["dt"],
            "req_id": root["fields"].get("req_id"),
            "trace": root["fields"].get("trace"),
            "sampled": bool(root["fields"].get("sampled")),
            "promoted": bool(root["fields"].get("promoted")),
            "failed": root["fields"].get("failed"),
            "phases": {p: round(v, 6) for p, v in phases.items()},
        })
    rows.sort(key=lambda r: -r["dt"])
    total = sum(agg.values())
    return {
        "spans": len(spans),
        "requests": len(roots),
        "slowest": rows[:top],
        "blame_total_s": {p: round(v, 6) for p, v in agg.items()},
        "blame_pct": {p: round(100.0 * v / total, 2) if total else 0.0
                      for p, v in agg.items()},
    }


# ====================================================== online engine

def _knob(env: str, default, convert=float):
    """Parse one secondary knob; a malformed value warns on stderr and
    falls back to its documented default, leaving blame armed."""
    raw = os.environ.get(env, "")
    if not raw:
        return default
    try:
        return convert(raw)
    except ValueError:
        import sys

        sys.stderr.write(f"hpnn obs: bad {env} value {raw!r}; "
                         f"using default {default}\n")
        return default


def _config() -> dict | None:
    global _cfg
    c = _cfg
    if c is None:
        with _lock:
            if _cfg is None:
                raw = os.environ.get(ENV_KNOB, "")
                if not raw or raw == "0":
                    _cfg = False
                else:
                    w = max(WINDOW_FLOOR, int(
                        _knob(ENV_WINDOW, DEFAULT_WINDOW, int)))
                    _cfg = {"window": w}
            c = _cfg
    return c if c is not False else None


def enabled() -> bool:
    """True when ``HPNN_BLAME`` is armed.  First call reads the env;
    later calls are a memo hit — the tap's whole unarmed cost."""
    return _config() is not None


def _evict_pending() -> None:
    """Drop the oldest buffered span (caller holds the lock): an
    orphan whose root never closed — a crashed request, or a tree
    deeper than the cap.  Its mass simply never blames, exactly as a
    torn sink line never blames offline."""
    ref, norm = _pending.popitem(last=False)
    _children.pop(ref, None)
    sibs = _children.get(norm["parent_ref"])
    if sibs is not None:
        try:
            sibs.remove(ref)
        except ValueError:
            pass
        if not sibs:
            _children.pop(norm["parent_ref"], None)


def _collect_tree(root: dict) -> list[dict]:
    """Pop the buffered descendant subtree of ``root`` (caller holds
    the lock) — the online twin of the offline children index, built
    incrementally by :func:`note_record`."""
    out = [root]
    stack = [root["ref"]]
    while stack:
        for ref in _children.pop(stack.pop(), ()):
            norm = _pending.pop(ref, None)
            if norm is not None:
                out.append(norm)
                stack.append(ref)
    return out


def _fold(root: dict, phases: dict) -> dict | None:
    """Fold one root's split into the rolling window (caller holds the
    lock).  Returns the gauge batch to publish outside the lock when
    the stride elapsed, else None."""
    global _roots_seen, _since_pub
    cfg = _cfg
    kernel = root["fields"].get("kernel") or "-"
    if kernel not in _kern and len(_kern) >= _KERNELS_CAP:
        kernel = "_other"
    _window.append((kernel, phases))
    for p, v in phases.items():
        _tot[p] += v
    ent = _kern.get(kernel)
    if ent is None:
        ent = _kern[kernel] = [0, {p: 0.0 for p in PHASES}]
    ent[0] += 1
    for p, v in phases.items():
        ent[1][p] += v
    while len(_window) > cfg["window"]:
        old_kernel, old = _window.popleft()
        for p, v in old.items():
            _tot[p] = max(0.0, _tot[p] - v)
        old_ent = _kern.get(old_kernel)
        if old_ent is not None:
            old_ent[0] -= 1
            for p, v in old.items():
                old_ent[1][p] = max(0.0, old_ent[1][p] - v)
            if old_ent[0] <= 0:
                del _kern[old_kernel]
    _roots_seen += 1
    _since_pub += 1
    if _since_pub < _STRIDE:
        return None
    _since_pub = 0
    return _gauge_batch()


def _pct(tot: dict) -> dict:
    total = sum(tot.values())
    return {p: (100.0 * v / total if total else 0.0)
            for p, v in tot.items()}


def _gauge_batch() -> dict:
    """The publishable gauge snapshot (caller holds the lock): the
    fleet-wide rolling split plus per-kernel rows for the heaviest
    window kernels."""
    fleet = _pct(_tot)
    ranked = sorted(_kern.items(),
                    key=lambda kv: (-sum(kv[1][1].values()), kv[0]))
    return {
        "fleet": fleet,
        "roots": len(_window),
        "kernels": {name: _pct(ent[1])
                    for name, ent in ranked[:_PER_KERNEL_TOP]},
    }


def _publish(batch: dict) -> None:
    """Emit the gauge batch OUTSIDE the lock (the registry takes its
    own lock and fans into sink/flight/collector/alert hooks)."""
    from hpnn_tpu_torch.obs import registry

    for p in PHASES:
        registry.gauge(GAUGE_OF[p], round(batch["fleet"][p], 3))
    registry.gauge("blame.window_roots", batch["roots"])
    for kernel, pcts in batch["kernels"].items():
        for p in PHASES:
            registry.gauge(GAUGE_OF[p], round(pcts[p], 3),
                           kernel=kernel)


def note_record(rec: dict) -> None:
    """The ``spans.finish`` tap: one emitted ``span.end`` record.
    Descendants buffer until their root closes (children always close
    before the root in the request lifecycle); a closing root pops its
    subtree, runs the shared split, and folds the result into the
    rolling window.  Constant-time no-op when unarmed."""
    cfg = _config()
    if cfg is None:
        return
    norm = normalize_record(rec)
    batch = None
    with _lock:
        is_root = (norm["name"] in ROOT_NAMES
                   and norm["parent_ref"] not in _pending)
        if not is_root:
            ref = norm["ref"]
            if ref is None:
                return
            _pending[ref] = norm
            parent = norm["parent_ref"]
            if parent is not None:
                _children.setdefault(parent, []).append(ref)
            while len(_pending) > _PENDING_CAP:
                _evict_pending()
            return
        tree = _collect_tree(norm)
        phases = split(norm, index_children(tree))
        batch = _fold(norm, phases)
    if batch is not None:
        _publish(batch)


def flush() -> None:
    """Force a gauge publish now (tests, drills, clean shutdowns)
    regardless of the stride.  No-op when unarmed or before the first
    root."""
    global _since_pub
    if _config() is None:
        return
    with _lock:
        if not _roots_seen:
            return
        _since_pub = 0
        batch = _gauge_batch()
    _publish(batch)


def fleet_doc() -> dict | None:
    """The rolling fleet split — ``{"roots", "pct": {phase: pct},
    "total_s": {phase: s}}`` — the tune engine's sensor
    (hpnn_tpu_torch/tune/engine.py).  None when unarmed."""
    if _config() is None:
        return None
    with _lock:
        return {
            "roots": len(_window),
            "pct": {p: round(v, 3) for p, v in _pct(_tot).items()},
            "total_s": {p: round(v, 6) for p, v in _tot.items()},
        }


def kernel_doc() -> dict:
    """Per-kernel rolling splits (every tracked kernel, ranked by
    window mass) for ``/healthz`` and the capsule artifact."""
    with _lock:
        ranked = sorted(_kern.items(),
                        key=lambda kv: (-sum(kv[1][1].values()), kv[0]))
        return {name: {"roots": ent[0],
                       "pct": {p: round(v, 3)
                               for p, v in _pct(ent[1]).items()}}
                for name, ent in ranked}


def health_doc() -> dict:
    """The blame census for ``/healthz``."""
    cfg = _config()
    if cfg is None:
        return {"armed": False}
    doc = fleet_doc()
    with _lock:
        pending = len(_pending)
        seen = _roots_seen
    return {"armed": True, "window": cfg["window"],
            "roots": doc["roots"], "roots_seen": seen,
            "pending_spans": pending, "pct": doc["pct"],
            "kernels": kernel_doc()}


def sketch_doc() -> dict | None:
    """The ``blame.json`` capsule artifact (obs/triggers.py) — the
    rolling window's fleet + per-kernel splits at capture time.  None
    when unarmed."""
    cfg = _config()
    if cfg is None:
        return None
    doc = fleet_doc()
    return {"window": cfg["window"], "roots": doc["roots"],
            "fleet_pct": doc["pct"], "fleet_total_s": doc["total_s"],
            "kernels": kernel_doc()}


# ------------------------------------------------------------ control

def configure(value, *, window=None) -> None:
    """Programmatic twin of the env knobs: arm online blame with any
    truthy ``value`` — or disarm with None/""/0, which also clears
    ``HPNN_BLAME_WINDOW`` — optionally pinning the window, and forget
    the memo.  Callers re-running ``obs.configure`` afterwards also
    refresh the registry's file-less activation."""
    if not value or value == "0":
        for env in (ENV_KNOB, ENV_WINDOW):
            os.environ.pop(env, None)
    else:
        os.environ[ENV_KNOB] = str(value)
        if window is not None:
            os.environ[ENV_WINDOW] = str(int(window))
    _reset_for_tests()


def _reset_for_tests() -> None:
    global _cfg, _roots_seen, _since_pub
    with _lock:
        _cfg = None
        _pending.clear()
        _children.clear()
        _window.clear()
        for p in PHASES:
            _tot[p] = 0.0
        _kern.clear()
        _roots_seen = 0
        _since_pub = 0
