"""``obs_collector`` — the fleet telemetry collector as a process.

A copy of ``hpnn_tpu/cli/obs_collector.py`` with its imports re-pointed at
``hpnn_tpu_torch``.

Stands up :func:`hpnn_tpu_torch.obs.collector.start_collector` and runs it
until interrupted: workers armed with ``HPNN_COLLECTOR=<url>`` push
record batches to ``POST /v1/telemetry``; the merged stream lands in
``--out`` (JSONL, each record tagged with the sender's pid/rank) and
the fleet aggregates are served on ``GET /metrics`` (Prometheus) and
``GET /fleetz`` (JSON).  Long options only — this is a serving-side tool
with no reference counterpart:

    obs_collector [--port N] [--host H] [--out PATH] [--queue N]
                  [--scrape URL[,URL...]] [--interval S]
                  [--capsule-dir DIR]

``--capsule-dir`` (the CLI twin of ``HPNN_CAPSULE_DIR``) arms capture
capsules on the collector process itself: ``POST /v1/capture`` snaps
the fleet view — merged aggregates, recv census — into a capsule
directory (obs/triggers.py; docs/observability.md "Forensics").

``--scrape`` adds the pull half: the listed worker ``/metrics``
endpoints are polled every ``--interval`` seconds (default 5) for
liveness, reported under ``/fleetz``'s ``scrape`` key.  stdout stays
silent (the token protocol is sacred even here); diagnostics go to
stderr.  See docs/observability.md "Fleet telemetry".
"""

from __future__ import annotations

import sys

from hpnn_tpu_torch.cli import common


def main(argv: list[str] | None = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    common.install_sigpipe_handler()
    argv, opts = common.extract_long_opts(
        argv,
        valued=("port", "host", "out", "queue", "scrape", "interval",
                "capsule-dir"),
    )
    if argv is None:
        return -1
    for name in ("port", "queue"):
        v = opts.get(name)
        if v is not None and (not str(v).isdigit()
                              or (name == "port" and int(v) > 65535)):
            sys.stderr.write(f"syntax error: bad --{name} parameter!\n")
            return -1
    interval = opts.get("interval")
    if interval is not None:
        try:
            ok = float(interval) > 0.0
        except ValueError:
            ok = False
        if not ok:
            sys.stderr.write("syntax error: bad --interval parameter!\n")
            return -1
    if argv:
        sys.stderr.write("syntax error: unrecognized option!\n")
        return -1

    from hpnn_tpu_torch.obs import collector

    if "capsule-dir" in opts:
        from hpnn_tpu_torch import obs

        obs.triggers.configure(opts["capsule-dir"])
    try:
        server = collector.start_collector(
            host=opts.get("host", "127.0.0.1"),
            port=int(opts.get("port", 8790)),
            path=opts.get("out"),
            queue_max=int(opts.get("queue", 1024)),
        )
    except OSError as exc:
        sys.stderr.write(f"obs_collector: cannot start: {exc}\n")
        return -1
    host, port = server.server_address[:2]
    sys.stderr.write(
        f"obs_collector: listening on {host}:{port} "
        f"(out={opts.get('out') or '-'})\n")
    scrape = [u for u in (opts.get("scrape") or "").split(",") if u]
    if scrape:
        server.collector.start_scraper(
            scrape, interval_s=float(opts.get("interval", 5.0)))
        sys.stderr.write(
            f"obs_collector: scraping {len(scrape)} endpoint(s)\n")
    common.shield_sigpipe_for_server()
    try:
        # join in slices: a bare join() can mask KeyboardInterrupt
        while server._thread.is_alive():
            server._thread.join(1.0)
    except KeyboardInterrupt:
        pass
    finally:
        collector.stop_collector(server)
    return 0


if __name__ == "__main__":
    sys.exit(main())
