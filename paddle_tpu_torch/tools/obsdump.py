#!/usr/bin/env python
# Copied from the JAX package's tools/obsdump.py with declared
# changes (tests/test_torch_imports.py, OBSDUMP_CHANGES).
"""obsdump — pretty-print observability dumps and rebuild chrome traces.

Offline companion to paddle_tpu_torch/observability/: the `snapshot` and
`trace` subcommands work on files alone and load ONLY
observability/metrics.py + tracing.py (stdlib-only modules, imported by
file path) — no framework or torch import, so they run in milliseconds on
a CI host or a laptop holding a copied run dir. `snapshot --live`
imports the framework and reads the in-process registry instead.

Usage (`python paddle_tpu_torch/tools/obsdump.py ...` by file path,
or `python -m paddle_tpu_torch.tools.obsdump ...`, which imports torch):
  obsdump.py snapshot METRICS.json          # aligned table of every metric
  obsdump.py snapshot METRICS.json --prom   # Prometheus text exposition
  obsdump.py snapshot --live [--prom]       # current process registry
  obsdump.py trace RUN_DIR -o out.json      # merge spans.json + the
                                            # profiler's <host>.trace.json
                                            # RUN_DIR into ONE chrome trace
  obsdump.py trace TRACE_DIR --list-traces  # distributed traces found
                                            # in a PADDLE_TPU_TRACE_DIR
                                            # (per-process trace-*.jsonl
                                            # sinks), newest first
  obsdump.py trace TRACE_DIR --trace-id ID  # reassemble ONE request's
                                            # cross-process span TREE
                                            # (router + N replicas + PS
                                            # servers) as an indented
                                            # table; --chrome -o out.json
                                            # writes it as a merged
                                            # chrome trace instead
  obsdump.py events EVENTS.jsonl            # tail the JSONL event log
                                            # (-n N, --kind K, --json,
                                            # --follow)
  obsdump.py cache METRICS.json             # per-kind persistent
                                            # compile-cache hit/miss/
                                            # bytes table (--live,
                                            # --json)
  obsdump.py analysis METRICS.json          # static-analysis findings
                                            # per pass/severity + walk
                                            # counts (--live, --json)
  obsdump.py locks METRICS.json             # lock held-seconds/
                                            # contention tables +
                                            # observed order inversions
                                            # (PADDLE_TPU_LOCKCHECK;
                                            # --live, --json)
  obsdump.py fleet METRICS.json             # serving-fleet summary:
                                            # world size, per-replica
                                            # ejections/retries/breaker
                                            # states, autoscale actions
                                            # (--live, --json,
                                            # --events LOG)
  obsdump.py tenants METRICS.json           # multi-tenant serving
                                            # summary: per-tenant
                                            # outcomes/tokens/p99,
                                            # sheds by tier+kind,
                                            # per-model registry
                                            # versions + hot-swaps
                                            # (--live, --json,
                                            # --events LOG)
  obsdump.py top TS_DIR                     # fleet dashboard from a
                                            # PADDLE_TPU_TS_DIR: rates,
                                            # error %, p50/p99, token
                                            # throughput merged across
                                            # recording pids (--window,
                                            # --watch S, --json)
  obsdump.py slo TS_DIR --spec SLOS.json    # SLO objective table:
                                            # target, current, fast/slow
                                            # burn rates, alert state
                                            # (--window-scale, --json)
  obsdump.py mem METRICS.json               # per-owner HBM attribution
                                            # (kv_pool/params/optimizer/
                                            # other), watermark, budget
                                            # state (--live forces a
                                            # fresh sweep + top-buffer
                                            # ranking, --json)
  obsdump.py profile DIR                    # render a /v1/profile
                                            # capture dir: merged
                                            # chrome-trace summary +
                                            # MFU/memory attribution
                                            # tables (--url URL triggers
                                            # a capture on a live
                                            # server first, --seconds,
                                            # --json)

Mixed-precision runs: `snapshot` surfaces the dynamic loss-scaling
counters (paddle_tpu_amp_total{event=overflow|growth|skip}, the
paddle_tpu_amp_loss_scale gauge) and the quantization-scale histogram
(paddle_tpu_quant_scale{kind}); `events --kind amp_overflow` tails the
scale-thrash timeline and `events --kind quantize` the calibration
story (PROFILE.md §Precision).

The metrics JSON is what the registry's env-gated dumper
(PADDLE_TPU_METRICS_DIR) writes; RUN_DIR is typically the profiler's
profile_path (the torch profiler's <host>.trace.json, paddle_tpu_torch/profiler.py) optionally holding a spans.json from
observability.save_spans().
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

_OBS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "observability")


_OBS_CACHE = {}


def _load_obs_module(name: str):
    """Import observability/<name>.py by file path, bypassing the
    paddle_tpu_torch package __init__ (which drags in torch). metrics.py,
    tracing.py, aggregate.py and slo.py are stdlib-only by contract
    (their module docstrings). Memoized: repeated loads (a --watch
    refresh loop) must not re-exec the module each frame."""
    mod = _OBS_CACHE.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(
            f"_obsdump_{name}", os.path.join(_OBS_DIR, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _OBS_CACHE[name] = mod
    return mod


def _fmt_value(v):
    import math

    if isinstance(v, float):
        # NaN/Inf are legitimate gauge values (a NaN grad-norm is exactly
        # what the health metrics record) — int() would raise on them
        if not math.isfinite(v) or v != int(v):
            return f"{v:.6g}"
        return str(int(v))
    return str(v)


def _fmt_labels(labels):
    if not labels:
        return ""
    return "{" + ",".join(f"{k}={v}" for k, v in sorted(labels.items())) \
        + "}"


def print_snapshot(snap, out=sys.stdout):
    """Aligned table: name{labels}  value   (histograms: count/sum/avg)."""
    rows = []
    for name in sorted(snap):
        m = snap[name]
        for s in m["series"]:
            label = name + _fmt_labels(s.get("labels", {}))
            if m["type"] == "histogram":
                cnt, tot = s["count"], s["sum"]
                avg = tot / cnt if cnt else 0.0
                val = (f"count={cnt} sum={tot:.6g} avg={avg:.6g}")
            else:
                val = _fmt_value(s["value"])
            rows.append((label, m["type"], val))
        if not m["series"]:
            rows.append((name, m["type"], "(no samples)"))
    width = max((len(r[0]) for r in rows), default=0)
    for label, kind, val in rows:
        print(f"{label:{width}s}  {kind:9s}  {val}", file=out)


def cmd_snapshot(args) -> int:
    snap = _load_snap(args)
    if snap is None:
        print("snapshot: need a metrics.json path or --live",
              file=sys.stderr)
        return 2
    if args.prom:
        sys.stdout.write(
            _load_obs_module("metrics").render_prometheus_snapshot(snap))
    else:
        print_snapshot(snap)
    return 0


def _print_trace_tree(tracing, records, trace_id):
    """Indented cross-process tree: name, duration, pid, cat, args."""
    roots = tracing.build_trace_tree(records, trace_id)
    if not roots:
        return False
    import datetime

    t0 = min(r.get("ts", 0.0) for r in records
             if r.get("trace_id") == trace_id)
    print(f"trace {trace_id}  start "
          f"{datetime.datetime.fromtimestamp(t0).isoformat(timespec='milliseconds')}"
          f"  ({len([r for r in records if r.get('trace_id') == trace_id])}"
          f" spans, {len(roots)} root(s))")

    def walk(node, depth):
        args = {k: v for k, v in (node.get("args") or {}).items()}
        detail = " ".join(f"{k}={v}" for k, v in sorted(args.items()))
        off = (node.get("ts", 0.0) - t0) * 1000
        print(f"  {'  ' * depth}{node['name']:<{max(1, 40 - 2 * depth)}}"
              f" {node.get('dur', 0.0) * 1000:9.3f}ms"
              f"  +{off:8.3f}ms  pid={node.get('pid', '?'):<7}"
              f" [{node.get('cat', '?')}]"
              + (f"  {detail}" if detail else ""))
        for c in node["children"]:
            walk(c, depth + 1)

    for root in roots:
        walk(root, 0)
    return True


def cmd_trace(args) -> int:
    if not os.path.isdir(args.run_dir):
        print(f"trace: not a directory: {args.run_dir}", file=sys.stderr)
        return 2
    tracing = _load_obs_module("tracing")
    if args.list_traces or args.trace_id:
        records = tracing.read_trace_dir(args.run_dir)
        if not records:
            print(f"trace: no trace-*.jsonl sinks under {args.run_dir} "
                  f"(is PADDLE_TPU_TRACE_DIR / PADDLE_TPU_TRACE_SAMPLE "
                  f"set on the fleet?)", file=sys.stderr)
            return 1
        if args.list_traces:
            import datetime

            rows = tracing.trace_summaries(records)
            for r in rows:
                r["start"] = datetime.datetime.fromtimestamp(
                    r.pop("start_ts")).isoformat(timespec="milliseconds")
            _print_aligned(rows, ("trace_id", "spans", "processes",
                                  "root", "wall_ms", "start"))
            return 0
        mine = [r for r in records if r.get("trace_id") == args.trace_id]
        if not mine:
            print(f"trace: no spans for trace_id {args.trace_id} under "
                  f"{args.run_dir}", file=sys.stderr)
            return 1
        if args.chrome:
            trace = tracing.merge_chrome_traces(
                [tracing.trace_records_to_chrome(mine)])
            with open(args.output, "w") as f:
                json.dump(trace, f)
            print(f"wrote {args.output}: "
                  f"{len(trace['traceEvents'])} events for trace "
                  f"{args.trace_id}")
            return 0
        return 0 if _print_trace_tree(tracing, records,
                                      args.trace_id) else 1
    lists = []
    spans_json = os.path.join(args.run_dir, "spans.json")
    if os.path.exists(spans_json):
        with open(spans_json) as f:
            spans = [tracing.Span(**s) for s in json.load(f)]
        lists.append(tracing.spans_to_chrome_events(spans))
    for p in tracing.find_device_traces(args.run_dir):
        try:
            lists.append(tracing._load_chrome_trace(p))
        except (OSError, ValueError) as e:
            print(f"trace: skipping unreadable {p}: {e}", file=sys.stderr)
    if not lists:
        print(f"trace: nothing to merge under {args.run_dir} (no "
              f"spans.json or *.trace.json[.gz])", file=sys.stderr)
        return 1
    trace = tracing.merge_chrome_traces(lists)
    with open(args.output, "w") as f:
        json.dump(trace, f)
    print(f"wrote {args.output}: {len(trace['traceEvents'])} events from "
          f"{len(lists)} source(s)")
    return 0


def _fmt_event(ev) -> str:
    import datetime

    ts = ev.get("ts")
    when = datetime.datetime.fromtimestamp(ts).isoformat(
        timespec="milliseconds") if isinstance(ts, (int, float)) else "?"
    rest = {k: v for k, v in ev.items()
            if k not in ("seq", "ts", "kind")}
    detail = " ".join(f"{k}={v}" for k, v in sorted(rest.items()))
    return f"{ev.get('seq', '?'):>6}  {when}  " \
           f"{ev.get('kind', '?'):<13} {detail}"


def _rotated_handle(f, path):
    """Rotation detector for --follow: when the sink was renamed away
    (PADDLE_TPU_EVENT_LOG_MAX_BYTES rollover moved it to <path>.1) or
    truncated, the open handle points at the OLD inode — its readline()
    returns "" forever while fresh events land in a new file. Returns a
    fresh handle (old one closed, reading the new file from the start)
    or None when nothing rotated / the new file isn't there yet."""
    try:
        st = os.stat(path)
        fst = os.fstat(f.fileno())
    except OSError:
        return None  # mid-rotation: the name will reappear next poll
    if (st.st_ino, st.st_dev) == (fst.st_ino, fst.st_dev) \
            and st.st_size >= f.tell():
        return None
    try:
        nf = open(path)
    except OSError:
        return None
    f.close()
    return nf


def cmd_events(args) -> int:
    """Tail/filter the observability JSONL event log (events.py emit
    format). --follow polls for appended lines until interrupted (and
    survives size-capped rotation: a renamed-away sink is detected by
    inode and the fresh file picked up from its start); it is OFF by
    default so scripted callers terminate."""
    if not os.path.isfile(args.path):
        print(f"events: no such file: {args.path}", file=sys.stderr)
        return 2

    def _parse(line):
        try:
            ev = json.loads(line)
        except ValueError:
            return None  # crash mid-append truncates the last line
        if args.kind and ev.get("kind") != args.kind:
            return None
        return ev

    # ONE handle for tail + follow: after read() the position is exactly
    # where the tail ended, so events appended while we print the tail
    # are picked up by the follow loop instead of falling into a gap
    with open(args.path) as f:
        text = f.read()
        # an event being appended RIGHT NOW can straddle the read: carry
        # the unterminated trailing fragment into the follow buffer
        # rather than dropping it as a malformed tail line
        buf = ""
        if text and not text.endswith("\n"):
            nl = text.rfind("\n")
            text, buf = text[:nl + 1], text[nl + 1:]
        evs = [ev for ev in map(_parse, text.splitlines()) if ev]
        if args.n is not None and args.n >= 0:
            evs = evs[-args.n:] if args.n else []
        for ev in evs:
            print(json.dumps(ev) if args.json else _fmt_event(ev))
        if not args.follow:
            return 0
        import time as _time
        try:
            while True:
                chunk = f.readline()
                if not chunk:
                    # EOF: either idle, or the sink rotated underneath
                    # us — finish the old inode first (we just did),
                    # then hop onto the fresh file
                    nf = _rotated_handle(f, args.path)
                    if nf is not None:
                        f, buf = nf, ""
                        continue
                    _time.sleep(0.2)
                    continue
                buf += chunk
                if not buf.endswith("\n"):
                    continue  # line still being written; keep buffering
                line, buf = buf, ""
                ev = _parse(line)
                if ev is not None:
                    print(json.dumps(ev) if args.json else _fmt_event(ev),
                          flush=True)
        except KeyboardInterrupt:
            pass
        finally:
            f.close()  # may be the rotated-onto handle, not the with-target
    return 0


def cmd_cache(args) -> int:
    """Per-kind persistent compile-cache summary from a metrics
    snapshot: hit/miss/corrupt/store/evict counts and the bytes moved,
    i.e. the restart-storm story of PADDLE_TPU_COMPILE_CACHE
    (PROFILE.md §Compile-cache) in one table."""
    snap = _load_snap(args)
    if snap is None:
        print("cache: need a metrics.json path or --live",
              file=sys.stderr)
        return 2

    counts = {}  # (kind, event) -> count
    nbytes = {}  # (kind, event) -> bytes
    for name, dest in (("paddle_tpu_compile_cache_total", counts),
                       ("paddle_tpu_compile_cache_bytes_total", nbytes)):
        for s in (snap.get(name) or {}).get("series", []):
            labels = s.get("labels", {})
            key = (labels.get("kind", "?"), labels.get("event", "?"))
            dest[key] = dest.get(key, 0) + s.get("value", 0)
    kinds = sorted({k for k, _ in list(counts) + list(nbytes)})
    if not kinds:
        print("no compile-cache samples in this snapshot (is "
              "PADDLE_TPU_COMPILE_CACHE set?)")
        return 0

    events = ("hit", "miss", "corrupt", "store", "store_error", "evict")
    rows = []
    for kind in kinds:
        c = {ev: int(counts.get((kind, ev), 0)) for ev in events}
        b = {ev: int(nbytes.get((kind, ev), 0)) for ev in events}
        lookups = c["hit"] + c["miss"] + c["corrupt"]
        rows.append({
            "kind": kind, **c,
            "hit_rate": round(c["hit"] / lookups, 4) if lookups else 0.0,
            "hit_bytes": b["hit"], "store_bytes": b["store"],
            "evict_bytes": b["evict"],
        })
    if args.json:
        print(json.dumps(rows, indent=2))
        return 0
    _print_aligned(rows, ("kind", "hit", "miss", "corrupt", "store",
                          "store_error", "evict", "hit_rate",
                          "hit_bytes", "store_bytes", "evict_bytes"))
    return 0


def _print_aligned(rows, cols):
    """Right-aligned table shared by the cache/analysis summaries."""
    widths = {c: max(len(c), *(len(str(r[c])) for r in rows))
              for c in cols}
    print("  ".join(f"{c:>{widths[c]}}" for c in cols))
    for r in rows:
        print("  ".join(f"{str(r[c]):>{widths[c]}}" for c in cols))


def _load_snap(args):
    """Shared --live/path snapshot loader for summary subcommands."""
    if args.live:
        import paddle_tpu_torch  # noqa: F401 — registers all telemetry metrics

        from paddle_tpu_torch import observability
        return observability.snapshot()
    if not args.path:
        return None
    with open(args.path) as f:
        return json.load(f)


def cmd_analysis(args) -> int:
    """Static-analysis story from a metrics snapshot: how many pass
    walks ran (by wiring site) and the findings per pass/severity
    (paddle_tpu_torch/analysis, PADDLE_TPU_VALIDATE — ANALYSIS.md)."""
    snap = _load_snap(args)
    if snap is None:
        print("analysis: need a metrics.json path or --live",
              file=sys.stderr)
        return 2
    runs = {}
    for s in (snap.get("paddle_tpu_analysis_runs_total") or {}) \
            .get("series", []):
        runs[s.get("labels", {}).get("where", "?")] = int(s["value"])
    counts = {}  # (pass, severity) -> n
    for s in (snap.get("paddle_tpu_analysis_findings_total") or {}) \
            .get("series", []):
        labels = s.get("labels", {})
        key = (labels.get("pass", "?"), labels.get("severity", "?"))
        counts[key] = counts.get(key, 0) + int(s["value"])
    if not runs and not counts:
        print("no analysis samples in this snapshot (is "
              "PADDLE_TPU_VALIDATE set, or did tools/analyze.py run?)")
        return 0
    severities = ("error", "warning", "info")
    rows = []
    for pass_name in sorted({p for p, _ in counts}):
        row = {"pass": pass_name}
        for sev in severities:
            row[sev] = counts.get((pass_name, sev), 0)
        rows.append(row)
    if args.json:
        print(json.dumps({"walks": runs, "findings": rows}, indent=2))
        return 0
    print("walks: " + (", ".join(f"{k}={v}"
                                 for k, v in sorted(runs.items()))
                       or "none"))
    if rows:
        _print_aligned(rows, ("pass",) + severities)
    else:
        print("no findings recorded")
    return 0


def cmd_locks(args) -> int:
    """Concurrency-sanitizer story from a metrics snapshot
    (PADDLE_TPU_LOCKCHECK, ANALYSIS.md §Concurrency): per-site
    held-seconds and contention table, plus the observed lock-order
    inversions against the tools/lock_order.json ledger."""
    snap = _load_snap(args)
    if snap is None:
        print("locks: need a metrics.json path or --live",
              file=sys.stderr)
        return 2

    held = {}  # site -> {count, sum}
    for s in (snap.get("paddle_tpu_lock_held_seconds") or {}) \
            .get("series", []):
        site = s.get("labels", {}).get("site", "?")
        held[site] = {"count": int(s.get("count", 0)),
                      "sum": float(s.get("sum", 0.0))}
    contention = {}
    for s in (snap.get("paddle_tpu_lock_contention_total") or {}) \
            .get("series", []):
        site = s.get("labels", {}).get("site", "?")
        contention[site] = contention.get(site, 0) + int(s["value"])
    inversions = []
    for s in (snap.get("paddle_tpu_lock_inversions_total") or {}) \
            .get("series", []):
        labels = s.get("labels", {})
        inversions.append({"first": labels.get("first", "?"),
                           "second": labels.get("second", "?"),
                           "count": int(s["value"])})
    deadlocks = sum(
        int(s["value"]) for s in
        (snap.get("paddle_tpu_lock_deadlocks_total") or {})
        .get("series", []))

    sites = sorted(set(held) | set(contention))
    if not sites and not inversions and not deadlocks:
        print("no lock_* samples in this snapshot (is "
              "PADDLE_TPU_LOCKCHECK set to 1 or 2?)")
        return 0
    rows = []
    for site in sites:
        h = held.get(site, {"count": 0, "sum": 0.0})
        rows.append({
            "site": site,
            "acquires": h["count"],
            "held_s": round(h["sum"], 4),
            "avg_ms": round(1000.0 * h["sum"] / h["count"], 3)
            if h["count"] else 0.0,
            "contention": contention.get(site, 0),
        })
    out = {"locks": rows, "inversions": inversions,
           "deadlocks": deadlocks}
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    if rows:
        _print_aligned(rows, ("site", "acquires", "held_s", "avg_ms",
                              "contention"))
    print(f"\ndeadlocks detected: {deadlocks}")
    if inversions:
        print("observed inversions (held -> acquired, against "
              "lock_order.json):")
        for inv in inversions:
            print(f"  {inv['first']} -> {inv['second']}  "
                  f"x{inv['count']}")
    else:
        print("observed inversions: none")
    return 0


def cmd_ps(args) -> int:
    """Parameter-server resilience story from a metrics snapshot
    (RESILIENCE.md §Parameter-server fault tolerance): RPC outcomes per
    op, reconnects + breaker state per endpoint, degraded seconds,
    gradient drops per var, and dedup-served retries. With --events it
    also tails the ps_failover events from a JSONL log."""
    snap = _load_snap(args)
    if snap is None:
        print("ps: need a metrics.json path or --live", file=sys.stderr)
        return 2

    def series(name):
        return (snap.get(name) or {}).get("series", [])

    rpc = {}  # (op, outcome) -> count
    for s in series("paddle_tpu_ps_rpc_total"):
        labels = s.get("labels", {})
        key = (labels.get("op", "?"), labels.get("outcome", "?"))
        rpc[key] = rpc.get(key, 0) + int(s["value"])
    endpoints = {}  # ep -> {reconnects, degraded_s, breaker}
    for s in series("paddle_tpu_ps_reconnects_total"):
        ep = s.get("labels", {}).get("endpoint", "?")
        endpoints.setdefault(ep, {})["reconnects"] = int(s["value"])
    for s in series("paddle_tpu_ps_degraded_seconds_total"):
        ep = s.get("labels", {}).get("endpoint", "?")
        endpoints.setdefault(ep, {})["degraded_s"] = round(
            float(s["value"]), 3)
    state_names = {0: "closed", 1: "half_open", 2: "open"}
    for s in series("paddle_tpu_ps_breaker_state"):
        ep = s.get("labels", {}).get("endpoint", "?")
        endpoints.setdefault(ep, {})["breaker"] = state_names.get(
            int(s.get("value", 0)), "?")
    drops = {s.get("labels", {}).get("var", "?"): int(s["value"])
             for s in series("paddle_tpu_ps_grad_drops_total")}
    dedups = sum(int(s["value"])
                 for s in series("paddle_tpu_ps_dedup_replies_total"))

    if not rpc and not endpoints and not drops:
        print("no ps_* samples in this snapshot (did a PS client/server "
              "run in this process?)")
        return 0

    outcomes = ("ok", "error", "retry", "unavailable")
    rpc_rows = []
    for op in sorted({o for o, _ in rpc}):
        row = {"op": op}
        for oc in outcomes:
            row[oc] = rpc.get((op, oc), 0)
        rpc_rows.append(row)
    ep_rows = [{"endpoint": ep,
                "breaker": info.get("breaker", "closed"),
                "reconnects": info.get("reconnects", 0),
                "degraded_s": info.get("degraded_s", 0.0)}
               for ep, info in sorted(endpoints.items())]
    out = {"rpc": rpc_rows, "endpoints": ep_rows,
           "grad_drops": drops, "dedup_replies": dedups}
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    if rpc_rows:
        _print_aligned(rpc_rows, ("op",) + outcomes)
    if ep_rows:
        print()
        _print_aligned(ep_rows, ("endpoint", "breaker", "reconnects",
                                 "degraded_s"))
    print(f"\ndedup-served retries: {dedups}")
    if drops:
        print("grad drops: " + ", ".join(f"{k}={v}"
                                         for k, v in sorted(drops.items())))
    if args.events:
        evs = _load_obs_module("events").read_jsonl(args.events, n=args.n,
                                                    kind="ps_failover")
        print(f"\nlast {len(evs)} ps_failover events:")
        for ev in evs:
            print("  " + _fmt_event(ev))
    return 0


def cmd_fleet(args) -> int:
    """Serving-fleet story from a metrics snapshot (SERVING.md §Fleet):
    world size + replica counts by state, per-endpoint picks/ejections/
    readmissions/breaker state, router request outcomes + retries by
    failure class, autoscaler actions, supervisor respawns, and the
    router latency histogram. With --events it also tails the `fleet`
    events from a JSONL log."""
    snap = _load_snap(args)
    if snap is None:
        print("fleet: need a metrics.json path or --live",
              file=sys.stderr)
        return 2

    def series(name):
        return (snap.get(name) or {}).get("series", [])

    def labeled(name, label):
        out = {}
        for s in series(name):
            key = s.get("labels", {}).get(label, "?")
            out[key] = out.get(key, 0) + s["value"]
        return out

    world = next((int(s["value"]) for s in
                  series("paddle_tpu_fleet_world_size")), None)
    replicas = {k: int(v) for k, v in
                labeled("paddle_tpu_fleet_replicas", "state").items()}
    requests = {k: int(v) for k, v in
                labeled("paddle_tpu_fleet_requests_total",
                        "outcome").items()}
    retries = {k: int(v) for k, v in
               labeled("paddle_tpu_fleet_retries_total",
                       "reason").items()}
    autoscale = {k: int(v) for k, v in
                 labeled("paddle_tpu_fleet_autoscale_total",
                         "direction").items()}
    respawns = sum(int(s["value"]) for s in
                   series("paddle_tpu_fleet_replica_respawns_total"))
    state_names = {0: "closed", 1: "half_open", 2: "open"}
    endpoints = {}  # ep -> {picks, ejections, readmissions, breaker}
    for name, field in (("paddle_tpu_fleet_picks_total", "picks"),
                        ("paddle_tpu_fleet_ejections_total",
                         "ejections"),
                        ("paddle_tpu_fleet_readmissions_total",
                         "readmissions")):
        for ep, v in labeled(name, "endpoint").items():
            endpoints.setdefault(ep, {})[field] = int(v)
    for s in series("paddle_tpu_fleet_breaker_state"):
        ep = s.get("labels", {}).get("endpoint", "?")
        endpoints.setdefault(ep, {})["breaker"] = state_names.get(
            int(s.get("value", 0)), "?")
    lat = _hist_summary(snap, "paddle_tpu_fleet_request_seconds")

    if world is None and not endpoints and not requests:
        print("no fleet_* samples in this snapshot (did a serving "
              "Router run in this process?)")
        return 0
    ep_rows = [{"endpoint": ep,
                "breaker": info.get("breaker", "closed"),
                "picks": info.get("picks", 0),
                "ejections": info.get("ejections", 0),
                "readmissions": info.get("readmissions", 0)}
               for ep, info in sorted(endpoints.items())]
    out = {"world_size": world, "replicas": replicas,
           "requests": requests, "retries": retries,
           "autoscale": autoscale, "respawns": respawns,
           "endpoints": ep_rows, "request_latency": lat}
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    print(f"world size: {world}  replicas: " +
          (", ".join(f"{k}={v}" for k, v in sorted(replicas.items()))
           or "none"))
    print("requests: " + (", ".join(f"{k}={v}" for k, v in
                                    sorted(requests.items()) if v)
                          or "none"))
    print("retries: " + (", ".join(f"{k}={v}" for k, v in
                                   sorted(retries.items()))
                         or "none"))
    print("autoscale: " + (", ".join(f"{k}={v}" for k, v in
                                     sorted(autoscale.items()))
                           or "none") + f"  respawns: {respawns}")
    if ep_rows:
        print()
        _print_aligned(ep_rows, ("endpoint", "breaker", "picks",
                                 "ejections", "readmissions"))
    if lat and lat.get("count"):
        print(f"\nrouter latency: n={lat['count']} "
              f"avg={lat['avg_ms']}ms p50~{lat['p50_ms']}ms "
              f"p99~{lat['p99_ms']}ms")
    if args.events:
        evs = _load_obs_module("events").read_jsonl(args.events,
                                                    n=args.n,
                                                    kind="fleet")
        print(f"\nlast {len(evs)} fleet events:")
        for ev in evs:
            print("  " + _fmt_event(ev))
    return 0


def _hist_summary(snap, name):
    """count / avg / estimated p50+p99 for an (unlabeled) histogram in
    a snapshot, via the ONE shared bucket-interpolation implementation
    (observability.metrics.bucket_quantile — aggregate.py and the SLO
    engine use the same one, so every tool agrees on what p99 means)."""
    series = (snap.get(name) or {}).get("series", [])
    if not series:
        return None
    s = series[0]
    count, total = int(s.get("count", 0)), float(s.get("sum", 0.0))
    if not count:
        return {"count": 0}
    bq = _load_obs_module("metrics").bucket_quantile
    buckets = s.get("buckets", [])
    return {"count": count, "avg_ms": round(1000 * total / count, 3),
            "p50_ms": round(1000 * (bq(0.50, buckets, count) or 0.0), 3),
            "p99_ms": round(1000 * (bq(0.99, buckets, count) or 0.0), 3)}


def cmd_decode(args) -> int:
    """Continuous-batching decode story from a metrics snapshot
    (SERVING.md §Continuous batching): queue depth, slot occupancy,
    KV-block accounting, token/step counters per phase, request
    outcomes, preemptions, and the TTFT / per-step latency histograms.
    With --events it also tails the decode events from a JSONL log."""
    snap = _load_snap(args)
    if snap is None:
        print("decode: need a metrics.json path or --live",
              file=sys.stderr)
        return 2

    def series(name):
        return (snap.get(name) or {}).get("series", [])

    def labeled(name, label):
        return {s.get("labels", {}).get(label, "?"): s["value"]
                for s in series(name)}

    gauges = {
        "queue_depth": next((int(s["value"]) for s in
                             series("paddle_tpu_decode_queue_depth")),
                            None),
        "slots": {k: int(v) for k, v in
                  labeled("paddle_tpu_decode_slots", "state").items()},
        "kv_blocks": {k: int(v) for k, v in
                      labeled("paddle_tpu_decode_kv_blocks",
                              "state").items()},
    }
    tokens = {k: int(v) for k, v in
              labeled("paddle_tpu_decode_tokens_total", "phase").items()}
    steps = {k: int(v) for k, v in
             labeled("paddle_tpu_decode_steps_total", "phase").items()}
    outcomes = {k: int(v) for k, v in
                labeled("paddle_tpu_decode_requests_total",
                        "outcome").items()}
    preempt = sum(int(s["value"]) for s in
                  series("paddle_tpu_decode_preemptions_total"))
    occ = (snap.get("paddle_tpu_decode_slot_occupancy") or {}) \
        .get("series", [])
    occ_avg = None
    if occ and occ[0].get("count"):
        occ_avg = round(float(occ[0]["sum"]) / occ[0]["count"], 3)
    ttft = _hist_summary(snap, "paddle_tpu_decode_ttft_seconds")
    step_h = _hist_summary(snap, "paddle_tpu_decode_step_seconds")
    prefix = {k: int(v) for k, v in
              labeled("paddle_tpu_prefix_cache_total", "event").items()}
    reused = next((int(s["value"]) for s in
                   series("paddle_tpu_decode_blocks_reused")), None)
    accept = next((round(float(s["value"]), 4) for s in
                   series("paddle_tpu_decode_spec_accept_rate")), None)
    kv_reuse = {"prefix_cache": prefix, "blocks_reused": reused,
                "spec_accept_rate": accept}

    if not tokens and not steps and gauges["queue_depth"] is None:
        print("no decode_* samples in this snapshot (did a DecodeEngine "
              "run in this process?)")
        return 0
    out = dict(gauges, tokens=tokens, steps=steps, requests=outcomes,
               preemptions=preempt, slot_occupancy_avg=occ_avg,
               ttft=ttft, step_seconds=step_h, kv_reuse=kv_reuse)
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    print(f"queue depth: {gauges['queue_depth']}")
    print("slots: " + (", ".join(f"{k}={v}" for k, v in
                                 sorted(gauges["slots"].items()))
                       or "none") +
          (f"  (occupancy avg {occ_avg})" if occ_avg is not None else ""))
    print("kv blocks: " + (", ".join(f"{k}={v}" for k, v in
                                     sorted(gauges["kv_blocks"].items()))
                           or "none"))
    print("tokens: " + (", ".join(f"{k}={v}" for k, v in
                                  sorted(tokens.items())) or "none"))
    print("steps: " + (", ".join(f"{k}={v}" for k, v in
                                 sorted(steps.items())) or "none"))
    print("requests: " + (", ".join(f"{k}={v}" for k, v in
                                    sorted(outcomes.items()) if v)
                          or "none"))
    print(f"preemptions: {preempt}")
    if prefix or reused or accept is not None:
        line = "kv reuse: " + (", ".join(
            f"{k}={v}" for k, v in sorted(prefix.items())) or "none")
        if reused is not None:
            line += f"  blocks_reused={reused}"
        if accept is not None:
            line += f"  spec_accept_rate={accept}"
        print(line)
    for label, h in (("ttft", ttft), ("step", step_h)):
        if h and h.get("count"):
            print(f"{label}: n={h['count']} avg={h['avg_ms']}ms "
                  f"p50~{h['p50_ms']}ms p99~{h['p99_ms']}ms")
    if args.events:
        evs = _load_obs_module("events").read_jsonl(args.events, n=args.n,
                                                    kind="decode")
        print(f"\nlast {len(evs)} decode events:")
        for ev in evs:
            print("  " + _fmt_event(ev))
    return 0


def cmd_tenants(args) -> int:
    """Multi-tenant serving story from a metrics snapshot (SERVING.md
    §Multi-tenancy): per-tenant request outcomes, token consumption
    and latency quantiles, shed counts by tier and kind (queue vs
    quota, replica-side and router-side), and the per-model registry
    view (adopted version, hot-swaps, publishes). With --events it
    also tails the shed/model_swap/registry events from a JSONL log."""
    snap = _load_snap(args)
    if snap is None:
        print("tenants: need a metrics.json path or --live",
              file=sys.stderr)
        return 2

    def series(name):
        return (snap.get(name) or {}).get("series", [])

    def labeled(name, label):
        out = {}
        for s in series(name):
            key = s.get("labels", {}).get(label, "?")
            out[key] = out.get(key, 0) + s["value"]
        return out

    bq = _load_obs_module("metrics").bucket_quantile

    def hist_by(name, label):
        """label value -> {count, avg_ms, p50_ms, p99_ms} for a
        labeled histogram."""
        out = {}
        for s in series(name):
            key = s.get("labels", {}).get(label, "?")
            count = int(s.get("count", 0))
            if not count:
                continue
            buckets = s.get("buckets", [])
            out[key] = {
                "count": count,
                "avg_ms": round(1000 * float(s.get("sum", 0.0))
                                / count, 3),
                "p50_ms": round(1000 * (bq(0.50, buckets, count)
                                        or 0.0), 3),
                "p99_ms": round(1000 * (bq(0.99, buckets, count)
                                        or 0.0), 3)}
        return out

    # tenant -> tier and tenant -> outcome counts from the one
    # three-way labeled counter
    tiers, outcomes = {}, {}
    for s in series("paddle_tpu_serving_tenant_requests_total"):
        lab = s.get("labels", {})
        t = lab.get("tenant", "?")
        tiers.setdefault(t, lab.get("tier", "?"))
        outcomes.setdefault(t, {})
        oc = lab.get("outcome", "?")
        outcomes[t][oc] = outcomes[t].get(oc, 0) + int(s["value"])
    tokens = {k: int(v) for k, v in labeled(
        "paddle_tpu_serving_tenant_tokens_total", "tenant").items()}
    lat = hist_by("paddle_tpu_serving_tenant_request_seconds", "tenant")
    ttft = hist_by("paddle_tpu_decode_tenant_ttft_seconds", "tenant")
    sheds = {}  # (tier, kind) -> n, replica-side
    for s in series("paddle_tpu_serving_sheds_total"):
        lab = s.get("labels", {})
        key = (lab.get("tier", "?"), lab.get("kind", "?"))
        sheds[key] = sheds.get(key, 0) + int(s["value"])
    fleet_sheds = {k: int(v) for k, v in labeled(
        "paddle_tpu_fleet_sheds_total", "tier").items()}
    models = {}  # model -> {version, swaps, publishes}
    for name, field in (("paddle_tpu_model_version", "version"),
                        ("paddle_tpu_model_swaps_total", "swaps"),
                        ("paddle_tpu_registry_publishes_total",
                         "publishes")):
        for m, v in labeled(name, "model").items():
            models.setdefault(m, {})[field] = int(v)

    if not outcomes and not sheds and not models:
        print("no tenant/model samples in this snapshot (QoS policy "
              "and per-tenant metrics only record when a policy is "
              "configured — SERVING.md §Multi-tenancy)")
        return 0

    tenant_rows = []
    for t in sorted(set(outcomes) | set(tokens) | set(lat)):
        oc = outcomes.get(t, {})
        row = {"tenant": t, "tier": tiers.get(t, "?"),
               "ok": oc.get("ok", 0),
               "rejected": oc.get("rejected", 0),
               "timeout": oc.get("timeout", 0),
               "error": oc.get("error", 0),
               "tokens": tokens.get(t, 0)}
        h = lat.get(t) or ttft.get(t)
        row["p99_ms"] = h["p99_ms"] if h else None
        tenant_rows.append(row)
    shed_rows = [{"tier": tier, "kind": kind, "sheds": n}
                 for (tier, kind), n in sorted(sheds.items())]
    model_rows = [{"model": m, "version": info.get("version", 0),
                   "swaps": info.get("swaps", 0),
                   "publishes": info.get("publishes", 0)}
                  for m, info in sorted(models.items())]
    out = {"tenants": tenant_rows, "sheds": shed_rows,
           "fleet_sheds": fleet_sheds, "models": model_rows,
           "ttft": ttft}
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    if tenant_rows:
        _print_aligned(tenant_rows, ("tenant", "tier", "ok",
                                     "rejected", "timeout", "error",
                                     "tokens", "p99_ms"))
    if shed_rows:
        print("\nsheds (replica admission):")
        _print_aligned(shed_rows, ("tier", "kind", "sheds"))
    if fleet_sheds:
        print("router shed answers: " + ", ".join(
            f"{k}={v}" for k, v in sorted(fleet_sheds.items())))
    if model_rows:
        print("\nmodels:")
        _print_aligned(model_rows, ("model", "version", "swaps",
                                    "publishes"))
    if args.events:
        evs = [ev for ev in _load_obs_module("events").read_jsonl(
            args.events)
            if ev.get("kind") in ("shed", "model_swap",
                                  "model_swap_failed", "registry")]
        evs = evs[-args.n:]
        print(f"\nlast {len(evs)} tenant/model events:")
        for ev in evs:
            print("  " + _fmt_event(ev))
    return 0


def _top_view(store, window):
    """One frame of the fleet dashboard: windowed rates/quantiles merged
    across every recording pid in the TS dir."""
    req = store.rate("paddle_tpu_fleet_requests_total", window,
                     by="outcome")
    total = sum(req.values())
    bad = sum(v for k, v in req.items() if k != "ok")
    serv = store.rate("paddle_tpu_serving_requests_total", window,
                      by="outcome")
    toks = store.rate("paddle_tpu_decode_tokens_total", window,
                      by="phase")
    ms = 1000.0

    def q(name, p):
        v = store.quantile(p, name, window)
        return None if v is None else round(v * ms, 3)

    return {
        "window_s": window,
        "now": store.latest_ts(),
        "pids": store.pids(),
        "fleet": {
            "req_per_s": round(total, 3),
            "error_rate": round(bad / total, 4) if total else 0.0,
            "outcomes_per_s": {k: round(v, 3) for k, v in
                               sorted(req.items())},
            "retries_per_s": round(store.rate(
                "paddle_tpu_fleet_retries_total", window), 3),
            "p50_ms": q("paddle_tpu_fleet_request_seconds", 0.50),
            "p99_ms": q("paddle_tpu_fleet_request_seconds", 0.99),
            "picks_per_s": {k: round(v, 3) for k, v in sorted(
                store.rate("paddle_tpu_fleet_picks_total", window,
                           by="endpoint").items())},
        },
        "serving": {
            "req_per_s": {k: round(v, 3) for k, v in
                          sorted(serv.items())},
            "p50_ms": q("paddle_tpu_serving_request_seconds", 0.50),
            "p99_ms": q("paddle_tpu_serving_request_seconds", 0.99),
            "queue_depth": store.gauge_latest(
                "paddle_tpu_serving_queue_depth"),
        },
        "decode": {
            "tokens_per_s": {k: round(v, 3) for k, v in
                             sorted(toks.items())},
            "ttft_p50_ms": q("paddle_tpu_decode_ttft_seconds", 0.50),
            "ttft_p99_ms": q("paddle_tpu_decode_ttft_seconds", 0.99),
        },
    }


def _render_top(view):
    f, s, d = view["fleet"], view["serving"], view["decode"]
    print(f"fleet top — window {view['window_s']}s, "
          f"{len(view['pids'])} recording pid(s): "
          f"{','.join(str(p) for p in view['pids'])}")
    print(f"  router: {f['req_per_s']}/s "
          f"(err {100 * f['error_rate']:.2f}%, "
          f"retries {f['retries_per_s']}/s) "
          f"p50~{f['p50_ms']}ms p99~{f['p99_ms']}ms")
    if f["outcomes_per_s"]:
        print("    outcomes: " + ", ".join(
            f"{k}={v}/s" for k, v in f["outcomes_per_s"].items()))
    if f["picks_per_s"]:
        rows = [{"endpoint": k, "picks/s": v}
                for k, v in f["picks_per_s"].items()]
        _print_aligned(rows, ("endpoint", "picks/s"))
    if s["req_per_s"] or s["p99_ms"] is not None:
        print(f"  serving: " + (", ".join(
            f"{k}={v}/s" for k, v in s["req_per_s"].items()) or "idle")
            + f"  p50~{s['p50_ms']}ms p99~{s['p99_ms']}ms "
            f"queue={s['queue_depth']}")
    if d["tokens_per_s"]:
        print("  decode: " + ", ".join(
            f"{k}={v} tok/s" for k, v in d["tokens_per_s"].items())
            + f"  ttft p50~{d['ttft_p50_ms']}ms "
            f"p99~{d['ttft_p99_ms']}ms")


def cmd_top(args) -> int:
    """Terminal fleet dashboard from a PADDLE_TPU_TS_DIR: per-endpoint
    request rates, error rates, latency quantiles and token throughput,
    merged across every recording process; --watch refreshes live."""
    import time as _time

    agg = _load_obs_module("aggregate")
    frames = 0
    while True:
        store = agg.TSStore.load(args.ts_dir)
        if not store.records:
            print(f"top: no ts-*.jsonl records under {args.ts_dir} "
                  f"(is PADDLE_TPU_TS_DIR recording?)", file=sys.stderr)
            return 2
        view = _top_view(store, args.window)
        if frames and not args.json:
            print()
        if args.json:
            print(json.dumps(view))
        else:
            _render_top(view)
        frames += 1
        if not args.watch or (args.frames and frames >= args.frames):
            return 0
        _time.sleep(args.watch)


def cmd_slo(args) -> int:
    """Objective table for a TS dir + SLO spec: target, current good
    fraction, fast/slow burn rates, alert state — the offline view of
    what the in-process evaluator serves at GET /v1/slo."""
    slo = _load_obs_module("slo")
    try:
        slos = slo.load_spec(args.spec)
    except (OSError, ValueError) as e:
        print(f"slo: bad spec: {e}", file=sys.stderr)
        return 2
    eng = slo.SLOEngine(slos, args.ts_dir,
                        window_scale=args.window_scale)
    rows = eng.evaluate()
    if args.json:
        print(json.dumps(rows, indent=2))
        return 0
    table = []
    for r in rows:
        wins = {w["window"]: w for w in r["windows"]}
        fast, slow = wins.get("fast", {}), wins.get("slow", {})

        def burn(w):
            return (f"{w.get('burn_short', 0):.2f}/"
                    f"{w.get('burn_long', 0):.2f}") if w else "-"

        table.append({
            "slo": r["name"], "type": r["type"],
            "target": f"{100 * r['target']:g}%",
            "current": "-" if r["current"] is None
            else f"{100 * r['current']:.3f}%",
            "burn fast": burn(fast), "burn slow": burn(slow),
            "state": r["state"]})
    _print_aligned(table, ("slo", "type", "target", "current",
                           "burn fast", "burn slow", "state"))
    return 0


def _fmt_bytes(n) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024 or unit == "TiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}TiB"


def cmd_mem(args) -> int:
    """Per-owner HBM attribution: live bytes/buffers by owner
    (kv_pool/params/optimizer/executables/other), the process
    high-watermark, and the PADDLE_TPU_HBM_BUDGET_BYTES state —
    PROFILE.md §Continuous profiling. With --live a fresh forced sweep
    runs (including the ranked top-buffer list); from a snapshot file
    the owner gauges of the LAST sweep are tabled."""
    if args.live:
        import paddle_tpu_torch  # noqa: F401 — registers providers

        from paddle_tpu_torch.observability import memwatch
        rep = memwatch.report(top=True) or {}
        if args.json:
            print(json.dumps(rep, indent=2, default=str))
            return 0
        owners = rep.get("owners") or {}
        rows = [{"owner": o, "bytes": _fmt_bytes(b),
                 "raw_bytes": int(b)} for o, b in owners.items()]
        if rows:
            _print_aligned(rows, ("owner", "bytes", "raw_bytes"))
        else:
            print("no live device buffers")
        print(f"total     {_fmt_bytes(rep.get('total_bytes', 0))} "
              f"in {rep.get('buffers', 0)} buffer(s)")
        print(f"watermark {_fmt_bytes(rep.get('watermark_bytes', 0))}")
        budget = rep.get("budget_bytes") or 0
        print(f"budget    "
              f"{_fmt_bytes(budget) if budget else 'unset'} "
              f"({rep.get('budget_state', 'ok')})")
        print(f"executables {_fmt_bytes(rep.get('executable_bytes', 0))}"
              f" in {rep.get('executables', 0)} executable(s)")
        top = rep.get("top") or []
        if top:
            print("top buffers:")
            _print_aligned(
                [{"owner": t.get("owner", "?"),
                  "bytes": _fmt_bytes(t.get("nbytes", 0)),
                  "shape": str(t.get("shape", "?")),
                  "dtype": str(t.get("dtype", "?"))} for t in top],
                ("owner", "bytes", "shape", "dtype"))
        return 0
    snap = _load_snap(args)
    if snap is None:
        print("mem: need a metrics.json path or --live",
              file=sys.stderr)
        return 2
    owners = {}
    for s in (snap.get("paddle_tpu_hbm_bytes") or {}).get("series", []):
        owners[s.get("labels", {}).get("owner", "?")] = int(s["value"])

    def scalar(name):
        series = (snap.get(name) or {}).get("series", [])
        return int(series[0]["value"]) if series else 0

    rows = [{"owner": o, "bytes": _fmt_bytes(b), "raw_bytes": b}
            for o, b in sorted(owners.items(), key=lambda kv: -kv[1])]
    out = {"owners": owners,
           "watermark_bytes":
               scalar("paddle_tpu_hbm_watermark_bytes"),
           "budget_bytes": scalar("paddle_tpu_hbm_budget_bytes"),
           "executable_bytes": scalar("paddle_tpu_executable_bytes")}
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    if rows:
        _print_aligned(rows, ("owner", "bytes", "raw_bytes"))
    else:
        print("no paddle_tpu_hbm_bytes samples in this snapshot (no "
              "sweep ran, or introspection was off)")
    print(f"watermark {_fmt_bytes(out['watermark_bytes'])}")
    print(f"budget    "
          f"{_fmt_bytes(out['budget_bytes']) if out['budget_bytes'] else 'unset'}")
    print(f"executables {_fmt_bytes(out['executable_bytes'])}")
    return 0


def cmd_profile(args) -> int:
    """Render a /v1/profile capture: the merged chrome trace summary
    plus the attribution tables (per-kind MFU/step rates, per-owner
    HBM) the capture wrote alongside it. With --url, first trigger one
    bounded capture on a live server (a replica's serving port, the
    observability port, or the fleet router — the router reply
    aggregates per-replica artifacts and is printed as JSON)."""
    d = args.dir
    if args.url:
        import urllib.request
        body = json.dumps({"seconds": args.seconds}).encode()
        url = args.url.rstrip("/") + "/v1/profile"
        req = urllib.request.Request(
            url, data=body,
            headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(
                    req, timeout=args.seconds + 60) as r:
                out = json.loads(r.read())
        except OSError as e:
            print(f"profile: POST {url} failed: {e}", file=sys.stderr)
            return 1
        if "replicas" in out:  # router fan-out reply
            print(json.dumps(out, indent=2))
            return 0
        d = out.get("dir")
        print(f"captured {out.get('seconds')}s -> {d}")
    if not d:
        print("profile: need a capture dir or --url", file=sys.stderr)
        return 2
    trace_path = os.path.join(d, "trace.json")
    perf_path = os.path.join(d, "perf.json")
    summary = {"dir": d}
    try:
        with open(trace_path) as f:
            evs = json.load(f).get("traceEvents", [])
        by_name = {}
        for e in evs:
            if e.get("ph") == "X":
                by_name.setdefault(e.get("name", "?"), [0, 0.0])
                by_name[e["name"]][0] += 1
                by_name[e["name"]][1] += float(e.get("dur", 0)) / 1e3
        summary["trace_events"] = len(evs)
        summary["spans_by_name"] = {
            n: {"count": c, "total_ms": round(ms, 3)}
            for n, (c, ms) in sorted(by_name.items(),
                                     key=lambda kv: -kv[1][1])[:15]}
    except (OSError, ValueError) as e:
        summary["trace_error"] = str(e)
    try:
        with open(perf_path) as f:
            summary["perf"] = json.load(f)
    except (OSError, ValueError) as e:
        summary["perf_error"] = str(e)
    if args.json:
        print(json.dumps(summary, indent=2, default=str))
        return 0
    print(f"capture dir: {d}")
    print(f"trace: {summary.get('trace_events', '?')} event(s) "
          f"({trace_path})")
    spans = summary.get("spans_by_name") or {}
    if spans:
        _print_aligned(
            [{"span": n, "count": v["count"],
              "total_ms": v["total_ms"]} for n, v in spans.items()],
            ("span", "count", "total_ms"))
    perf = summary.get("perf") or {}
    kinds = perf.get("perfwatch") or {}
    if kinds:
        print("attribution (window at capture close):")
        _print_aligned(
            [{"kind": k, "mfu": round(v.get("mfu", 0.0), 6),
              "steps/s": round(v.get("steps_per_sec", 0.0), 2),
              "tok/s/chip":
                  round(v.get("tokens_per_sec_per_chip", 0.0), 2),
              "device": v.get("device_kind") or "?"}
             for k, v in sorted(kinds.items())],
            ("kind", "mfu", "steps/s", "tok/s/chip", "device"))
    mem = perf.get("memory") or {}
    owners = mem.get("owners") or {}
    if owners:
        print("memory owners:")
        _print_aligned(
            [{"owner": o, "bytes": _fmt_bytes(b)}
             for o, b in sorted(owners.items(), key=lambda kv: -kv[1])],
            ("owner", "bytes"))
        print(f"watermark {_fmt_bytes(mem.get('watermark_bytes', 0))}")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="obsdump", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("snapshot", help="pretty-print a metrics snapshot")
    sp.add_argument("path", nargs="?", help="metrics.json from "
                    "PADDLE_TPU_METRICS_DIR (omit with --live)")
    sp.add_argument("--live", action="store_true",
                    help="read this process's registry instead of a file")
    sp.add_argument("--prom", action="store_true",
                    help="emit Prometheus text exposition")
    sp.set_defaults(fn=cmd_snapshot)

    tp = sub.add_parser("trace", help="merge a run dir into one chrome "
                        "trace, or reassemble a distributed trace tree "
                        "from a PADDLE_TPU_TRACE_DIR")
    tp.add_argument("run_dir")
    tp.add_argument("-o", "--output", default="trace.json")
    tp.add_argument("--trace-id", default=None,
                    help="reassemble ONE trace's cross-process span "
                    "tree from the dir's trace-*.jsonl sinks (the "
                    "X-Request-Id response header is the trace id)")
    tp.add_argument("--list-traces", action="store_true",
                    help="list the distributed traces found in the "
                    "dir's trace-*.jsonl sinks, newest first")
    tp.add_argument("--chrome", action="store_true",
                    help="with --trace-id: write the trace as a merged "
                    "chrome trace to -o instead of printing the tree")
    tp.set_defaults(fn=cmd_trace)

    ep = sub.add_parser("events", help="tail/filter a JSONL event log")
    ep.add_argument("path", help="events.jsonl (PADDLE_TPU_EVENT_LOG)")
    ep.add_argument("-n", type=int, default=20,
                    help="show the last N events (default 20)")
    ep.add_argument("--kind", default=None,
                    help="only events of this kind (compile|step_summary|"
                    "anomaly|checkpoint|amp_overflow|quantize|...)")
    ep.add_argument("--json", action="store_true",
                    help="raw JSON objects instead of the aligned table")
    ep.add_argument("--follow", action="store_true",
                    help="keep polling for appended events (default off)")
    ep.set_defaults(fn=cmd_events)

    cp = sub.add_parser("cache", help="per-kind compile-cache "
                        "hit/miss/bytes from a metrics snapshot")
    cp.add_argument("path", nargs="?", help="metrics.json from "
                    "PADDLE_TPU_METRICS_DIR (omit with --live)")
    cp.add_argument("--live", action="store_true",
                    help="read this process's registry instead of a file")
    cp.add_argument("--json", action="store_true",
                    help="rows as JSON instead of the aligned table")
    cp.set_defaults(fn=cmd_cache)

    anp = sub.add_parser("analysis", help="static-analysis walks + "
                         "findings per pass/severity from a metrics "
                         "snapshot")
    anp.add_argument("path", nargs="?", help="metrics.json from "
                     "PADDLE_TPU_METRICS_DIR (omit with --live)")
    anp.add_argument("--live", action="store_true",
                     help="read this process's registry instead of a "
                     "file")
    anp.add_argument("--json", action="store_true",
                     help="JSON instead of the aligned table")
    anp.set_defaults(fn=cmd_analysis)

    lkp = sub.add_parser("locks", help="lock held-seconds/contention "
                         "tables + observed lock-order inversions from "
                         "a metrics snapshot (PADDLE_TPU_LOCKCHECK)")
    lkp.add_argument("path", nargs="?", help="metrics.json from "
                     "PADDLE_TPU_METRICS_DIR (omit with --live)")
    lkp.add_argument("--live", action="store_true",
                     help="read this process's registry instead of a "
                     "file")
    lkp.add_argument("--json", action="store_true",
                     help="JSON instead of the aligned tables")
    lkp.set_defaults(fn=cmd_locks)

    pp = sub.add_parser("ps", help="parameter-server resilience summary "
                        "(RPC outcomes, breakers, reconnects, drops) "
                        "from a metrics snapshot")
    pp.add_argument("path", nargs="?", help="metrics.json from "
                    "PADDLE_TPU_METRICS_DIR (omit with --live)")
    pp.add_argument("--live", action="store_true",
                    help="read this process's registry instead of a file")
    pp.add_argument("--json", action="store_true",
                    help="JSON instead of the aligned tables")
    pp.add_argument("--events", default=None, metavar="JSONL",
                    help="also tail ps_failover events from this event "
                    "log")
    pp.add_argument("-n", type=int, default=20,
                    help="with --events: last N events (default 20)")
    pp.set_defaults(fn=cmd_ps)

    dp = sub.add_parser("decode", help="continuous-batching decode "
                        "summary (queue, slots, KV blocks, TTFT, "
                        "per-step latency) from a metrics snapshot")
    dp.add_argument("path", nargs="?", help="metrics.json from "
                    "PADDLE_TPU_METRICS_DIR (omit with --live)")
    dp.add_argument("--live", action="store_true",
                    help="read this process's registry instead of a file")
    dp.add_argument("--json", action="store_true",
                    help="JSON instead of the summary lines")
    dp.add_argument("--events", default=None, metavar="JSONL",
                    help="also tail decode events from this event log")
    dp.add_argument("-n", type=int, default=20,
                    help="with --events: last N events (default 20)")
    dp.set_defaults(fn=cmd_decode)

    fp = sub.add_parser("fleet", help="serving-fleet summary (world "
                        "size, per-replica health/ejections/retries, "
                        "breaker states, autoscale actions) from a "
                        "metrics snapshot")
    fp.add_argument("path", nargs="?", help="metrics.json from "
                    "PADDLE_TPU_METRICS_DIR (omit with --live)")
    fp.add_argument("--live", action="store_true",
                    help="read this process's registry instead of a file")
    fp.add_argument("--json", action="store_true",
                    help="JSON instead of the summary lines")
    fp.add_argument("--events", default=None, metavar="JSONL",
                    help="also tail fleet events from this event log")
    fp.add_argument("-n", type=int, default=20,
                    help="with --events: last N events (default 20)")
    fp.set_defaults(fn=cmd_fleet)

    tnp = sub.add_parser("tenants", help="multi-tenant serving summary "
                         "(per-tenant outcomes/tokens/latency, sheds "
                         "by tier+kind, per-model registry versions "
                         "and hot-swaps) from a metrics snapshot")
    tnp.add_argument("path", nargs="?", help="metrics.json from "
                     "PADDLE_TPU_METRICS_DIR (omit with --live)")
    tnp.add_argument("--live", action="store_true",
                     help="read this process's registry instead of a "
                     "file")
    tnp.add_argument("--json", action="store_true",
                     help="JSON instead of the summary tables")
    tnp.add_argument("--events", default=None, metavar="JSONL",
                     help="also tail shed/model_swap/registry events "
                     "from this event log")
    tnp.add_argument("-n", type=int, default=20,
                     help="with --events: last N events (default 20)")
    tnp.set_defaults(fn=cmd_tenants)

    top = sub.add_parser("top", help="live fleet dashboard from a "
                         "PADDLE_TPU_TS_DIR time-series dir: request/"
                         "error rates, latency quantiles, token "
                         "throughput merged across recording pids")
    top.add_argument("ts_dir", help="PADDLE_TPU_TS_DIR with ts-*.jsonl "
                     "recorder segments")
    top.add_argument("--window", type=float, default=60.0,
                     help="trailing window seconds for rates/quantiles "
                     "(default 60)")
    top.add_argument("--watch", type=float, default=0.0, metavar="S",
                     help="refresh every S seconds (0 = render once)")
    top.add_argument("--frames", type=int, default=0,
                     help="with --watch: stop after N frames (0 = "
                     "until interrupted)")
    top.add_argument("--json", action="store_true",
                     help="one JSON object per frame instead of the "
                     "dashboard")
    top.set_defaults(fn=cmd_top)

    slp = sub.add_parser("slo", help="SLO objective table (target, "
                         "current, burn rates, alert state) from a "
                         "time-series dir + JSON spec")
    slp.add_argument("ts_dir", help="PADDLE_TPU_TS_DIR with ts-*.jsonl "
                     "recorder segments")
    slp.add_argument("--spec", required=True,
                     help="SLO spec JSON file (PROFILE.md §Time series "
                     "& SLOs)")
    slp.add_argument("--window-scale", type=float, default=1.0,
                     help="shrink every burn window uniformly "
                     "(PADDLE_TPU_SLO_WINDOW_SCALE equivalent; bench "
                     "dirs need ~0.001)")
    slp.add_argument("--json", action="store_true",
                     help="rows as JSON instead of the aligned table")
    slp.set_defaults(fn=cmd_slo)

    mp = sub.add_parser("mem", help="per-owner HBM attribution table "
                        "(watermark, budget state, top buffers)")
    mp.add_argument("path", nargs="?", help="metrics.json from "
                    "PADDLE_TPU_METRICS_DIR (omit with --live)")
    mp.add_argument("--live", action="store_true",
                    help="force a fresh sweep in this process (adds "
                    "the ranked top-buffer list)")
    mp.add_argument("--json", action="store_true",
                    help="report as JSON instead of the aligned table")
    mp.set_defaults(fn=cmd_mem)

    prp = sub.add_parser("profile", help="render a /v1/profile capture "
                         "dir (trace summary + attribution tables); "
                         "--url triggers a capture first")
    prp.add_argument("dir", nargs="?", help="capture artifact dir "
                     "(holds trace.json + perf.json)")
    prp.add_argument("--url", help="base URL of a live server "
                     "(replica, metrics port, or fleet router) to POST "
                     "/v1/profile at before rendering")
    prp.add_argument("--seconds", type=float, default=2.0,
                     help="capture window for --url (default 2s)")
    prp.add_argument("--json", action="store_true",
                     help="summary as JSON instead of tables")
    prp.set_defaults(fn=cmd_profile)

    # unknown/missing subcommands exit nonzero via argparse itself
    # (required=True subparsers error out with status 2)
    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
