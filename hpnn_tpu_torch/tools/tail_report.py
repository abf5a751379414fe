"""Slowest-N tail forensics over one or more of the port's obs sinks.

The twin of the repo's ``tools/tail_report.py`` over ``hpnn_tpu_torch``:
*which requests were slowest, and which phase of the serving pipeline is
to blame?*  It reads the sinks the port writes (worker ``HPNN_METRICS``
files and/or the collector's merged stream; several paths are joined in
one skew-tolerant timeline), rebuilds the request span trees (sampled or
promoted roots from ``HPNN_SAMPLE`` work exactly like full
``HPNN_SPANS`` trees), and prints:

* the **slowest-N request roots** (``serve.request`` /
  ``cluster.request``, outermost per trace), each with its per-phase
  blame split;
* the **aggregate blame** across every root;
* with ``--baseline``, a **paired comparison**: the same aggregates over
  a second sink set and the per-phase delta.

Spans are classified by the port's own ``obs/blame.py`` core
(``phase_of`` / ``split`` / ``analyze``: queue, dispatch, spill,
shed_retry, other and gap, each descendant charged its exclusive time),
the one the in-process ``HPNN_BLAME`` engine runs, so the offline report
and the online gauges cannot drift apart.  The three sink loaders are
copies of ``tools/obs_report.py``'s (``load_events``, ``merge_events``,
``collect_spans``): the port imports no repo tool.

    python -m hpnn_tpu_torch.tools.tail_report run.jsonl [more.jsonl ...]
    python -m hpnn_tpu_torch.tools.tail_report run.jsonl --top 20 --root serve.request
    python -m hpnn_tpu_torch.tools.tail_report run.jsonl --baseline before.jsonl
    python -m hpnn_tpu_torch.tools.tail_report run.jsonl --json
"""

from __future__ import annotations

import argparse
import json
import sys

from hpnn_tpu_torch.obs import blame as _core

ROOT_NAMES = _core.ROOT_NAMES
PHASES = _core.PHASES

request_roots = _core.request_roots
blame = _core.split
analyze = _core.analyze

# the record keys a span row keeps out of its ``fields``
_SPAN_META = ("ts", "ev", "kind", "span", "parent", "name", "t0", "dt",
              "remote_parent", "pid", "rank")


# ------------------------------------------------- loaders (copies)
def load_events(path: str) -> list[dict]:
    """Parse one JSONL sink, skipping lines a crash may have torn."""
    events = []
    with open(path) as fp:
        for line in fp:
            line = line.strip()
            if not line:
                continue
            try:
                events.append(json.loads(line))
            except json.JSONDecodeError:
                continue  # torn tail line from a crashed writer
    return events


def merge_events(paths: list[str]) -> list[dict]:
    """Join per-rank sinks into one timeline: each file's records tagged
    with its rank (its ``obs.open`` line's, else its position) and pid,
    per-rank timestamps clamped monotone, then a stable sort by
    ``(ts, rank, seq)``."""
    tagged = []
    for pos, path in enumerate(paths):
        events = load_events(path)
        rank, pid = pos, None
        for rec in events:
            if rec.get("ev") == "obs.open":
                if "rank" in rec:
                    rank = int(rec["rank"])
                if "pid" in rec:
                    pid = int(rec["pid"])
                break
        last_ts = 0.0
        for seq, rec in enumerate(events):
            ts = rec.get("ts")
            ts = float(ts) if isinstance(ts, (int, float)) else last_ts
            ts = max(ts, last_ts)
            last_ts = ts
            rec = dict(rec)
            rec.setdefault("rank", rank)
            if pid is not None:
                rec.setdefault("pid", pid)
            tagged.append((ts, rank, seq, rec))
    tagged.sort(key=lambda t: t[:3])
    return [rec for _ts, _rank, _seq, rec in tagged]


def collect_spans(events: list[dict]) -> list[dict]:
    """The ``span.end`` records, each keyed by a global
    ``"<pid-hex>:<id>"`` ref with its parent resolved in that key space
    (a local parent within its process, a ``remote_parent`` across
    processes); in ``t0`` order."""
    pid_of_rank: dict = {}
    default_pid = 0
    for rec in events:
        if rec.get("ev") == "obs.open" and "pid" in rec:
            default_pid = int(rec["pid"])
            pid_of_rank[rec.get("rank")] = default_pid
    spans = []
    for rec in events:
        if rec.get("ev") != "span.end":
            continue
        pid = rec.get("pid")
        if pid is None:
            pid = pid_of_rank.get(rec.get("rank"), default_pid)
        pid = int(pid)
        sid = rec.get("span")
        parent = rec.get("parent")
        if parent is not None:
            parent_ref = f"{pid:x}:{parent}"
        else:
            parent_ref = rec.get("remote_parent")
        spans.append({
            "span": sid,
            "parent": parent,
            "pid": pid,
            "ref": None if sid is None else f"{pid:x}:{sid}",
            "parent_ref": parent_ref,
            "name": rec.get("name", "?"),
            "t0": float(rec.get("t0", 0.0)),
            "dt": float(rec.get("dt", 0.0)),
            "fields": {k: v for k, v in rec.items() if k not in _SPAN_META},
        })
    spans.sort(key=lambda s: s["t0"])
    return spans


def load_spans(paths: list[str]) -> list[dict]:
    """All spans from the given sinks, cross-process refs resolved
    (several paths go through the skew-tolerant rank merge)."""
    events = (load_events(paths[0]) if len(paths) == 1
              else merge_events(paths))
    return collect_spans(events)


# --------------------------------------------------------- report
def compare(rep: dict, base: dict) -> dict:
    """The paired ``--baseline`` digest: per-phase percentage-point
    shifts plus the mean-root-latency ratio."""

    def _mean(r):
        n = r["requests"]
        return (sum(r["blame_total_s"].values()) / n) if n else 0.0

    mean_run, mean_base = _mean(rep), _mean(base)
    return {
        "requests": {"run": rep["requests"], "baseline": base["requests"]},
        "mean_root_s": {"run": round(mean_run, 6),
                        "baseline": round(mean_base, 6),
                        "ratio": (round(mean_run / mean_base, 3)
                                  if mean_base > 0 else None)},
        "blame_pct_delta": {
            p: round(rep["blame_pct"][p] - base["blame_pct"][p], 2)
            for p in PHASES},
    }


def _fmt_phases(phases: dict, dt: float) -> str:
    parts = []
    for p in PHASES:
        v = phases.get(p, 0.0)
        if v <= 0.0:
            continue
        pct = 100.0 * v / dt if dt > 0 else 0.0
        parts.append(f"{p} {pct:4.1f}%")
    return "  ".join(parts)


def render(rep: dict, cmp_doc: dict | None = None) -> str:
    out: list[str] = []
    w = out.append
    w("== tail report ==")
    w(f"spans: {rep['spans']}   request roots: {rep['requests']}")
    if not rep["requests"]:
        w("  (no request roots — was HPNN_SAMPLE or HPNN_SPANS set "
          "on the serving path?)")
        return "\n".join(out) + "\n"
    w("")
    w(f"-- slowest {len(rep['slowest'])} --")
    w(f"  {'dt_ms':>9s} {'name':16s} {'req_id':>14s} {'trace':>17s}"
      f"  blame")
    for r in rep["slowest"]:
        tag = "P" if r["promoted"] else "S" if r["sampled"] else " "
        flag = f" FAILED({r['failed']})" if r["failed"] else ""
        w(f"  {r['dt'] * 1e3:9.3f} {r['name']:16s}"
          f" {str(r['req_id'] or '-'):>14s}"
          f" {str(r['trace'] or '-'):>17s} {tag}"
          f" {_fmt_phases(r['phases'], r['dt'])}{flag}")
    w("")
    w("-- aggregate blame (all roots) --")
    for p in PHASES:
        w(f"  {p:10s} {rep['blame_total_s'][p]:10.6f} s"
          f"  {rep['blame_pct'][p]:6.2f}%")
    if cmp_doc is not None:
        w("")
        w("-- vs baseline --")
        m = cmp_doc["mean_root_s"]
        ratio = m["ratio"]
        w(f"  roots: {cmp_doc['requests']['run']} vs "
          f"{cmp_doc['requests']['baseline']} baseline")
        w(f"  mean root: {m['run'] * 1e3:.3f} ms vs"
          f" {m['baseline'] * 1e3:.3f} ms"
          + (f"  ({ratio:.2f}x)" if ratio else ""))
        for p in PHASES:
            d = cmp_doc["blame_pct_delta"][p]
            if abs(d) >= 0.01:
                w(f"  {p:10s} {d:+6.2f} pp")
    return "\n".join(out) + "\n"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Slowest-N request table with per-phase blame "
                    "over HPNN_METRICS sinks")
    ap.add_argument("paths", nargs="+", metavar="path",
                    help="metrics JSONL sink(s); several are merged "
                         "into one skew-tolerant timeline")
    ap.add_argument("--top", type=int, default=10, metavar="N",
                    help="rows in the slowest table (default 10)")
    ap.add_argument("--root", action="append", metavar="NAME",
                    help="request-root span name(s) (default: "
                         "serve.request + cluster.request)")
    ap.add_argument("--baseline", nargs="+", metavar="path",
                    help="baseline sink(s): append a paired "
                         "comparison (phase blame deltas)")
    ap.add_argument("--json", action="store_true",
                    help="machine form instead of text")
    args = ap.parse_args(argv)
    roots = tuple(args.root) if args.root else ROOT_NAMES
    try:
        rep = analyze(load_spans(args.paths), top=args.top,
                      root_names=roots)
        cmp_doc = None
        if args.baseline:
            base = analyze(load_spans(args.baseline), top=args.top,
                           root_names=roots)
            cmp_doc = compare(rep, base)
    except OSError as exc:
        sys.stderr.write(f"tail_report: {exc}\n")
        return 1
    if args.json:
        doc = dict(rep)
        if cmp_doc is not None:
            doc["baseline"] = cmp_doc
        json.dump(doc, sys.stdout, indent=2, default=str)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render(rep, cmp_doc))
    return 0


if __name__ == "__main__":
    sys.exit(main())
