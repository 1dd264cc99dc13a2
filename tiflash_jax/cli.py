"""Command-line tools.

Role analog: the reference's operator CLIs (`DTTool` inspect,
`PageCtl`) and the debug client — here: inspect tables, run JSON plans,
serve the HTTP service, dump metrics.

    python -m tiflash_jax.cli tables --tpch-sf 0.01
    python -m tiflash_jax.cli query plan.json --tpch-sf 0.01 [--distributed]
    python -m tiflash_jax.cli serve --tpch-sf 0.01 --port 8123
    python -m tiflash_jax.cli load-tbl DIR --tables lineitem,orders
"""

from __future__ import annotations

import argparse
import json
import sys


def _build_catalog(args):
    if args.tbl_dir:
        from .runtime.settings import Settings
        from .storage.native_loader import load_tpch_dir

        return load_tpch_dir(args.tbl_dir, args.tables.split(","),
                             nthreads=Settings.from_env().max_threads)
    from .storage.tpch import generate_tpch

    return generate_tpch(
        sf=args.tpch_sf,
        tables=args.tables.split(",") if args.tables else None,
    )


def _mesh(args):
    if not args.distributed:
        return None
    import jax
    import numpy as np
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), ("d",))


def _print_block(out, limit):
    cols = out.to_pylists()
    names = list(cols)
    print("\t".join(names))
    n = len(cols[names[0]]) if names else 0
    for i in range(min(n, limit)):
        print("\t".join(str(cols[c][i]) for c in names))
    if n > limit:
        print(f"... ({n} rows total)")


def _repl(cat, mesh, limit, inp=None, outp=None):
    """Interactive loop (the reference's debug-client / DBGInvoke analog).

    Commands:
      tables                      list catalog tables
      explain <json-plan>         print the plan tree
      <json-plan>                 execute and print rows (one line of JSON)
      \\i FILE                     execute a JSON plan from a file
      summary                     EXPLAIN ANALYZE of the last query
      quit / EOF                  exit
    """
    import io

    from .plan import serde
    from .runtime.executor import run_query

    inp = inp or sys.stdin
    outp = outp or sys.stdout
    last_summary = None

    def say(*a):
        print(*a, file=outp)

    say(f"tiflash-jax repl — {len(cat.tables)} tables; 'tables' to list, "
        "'quit' to exit")
    while True:
        try:
            print("tiflash> ", end="", file=outp, flush=True)
            line = inp.readline()
        except KeyboardInterrupt:
            break
        if not line:
            break
        line = line.strip()
        if not line:
            continue
        if line in ("quit", "exit"):
            break
        try:
            if line == "tables":
                for name, t in cat.tables.items():
                    say(f"{name}  rows={t.row_count}")
                continue
            if line == "summary":
                say(last_summary.pretty() if last_summary else "no query yet")
                continue
            if line.startswith("\\i "):
                with open(line[3:].strip()) as f:
                    line = f.read()
            explain = False
            if line.startswith("explain "):
                explain = True
                line = line[len("explain "):]
            plan = serde.plan_from_json(json.loads(line))
            if explain:
                say(plan.pretty())
                continue
            out, last_summary = run_query(plan, cat.blocks(), mesh=mesh)
            buf = io.StringIO()
            import contextlib

            with contextlib.redirect_stdout(buf):
                _print_block(out, limit)
            print(buf.getvalue(), end="", file=outp)
        except Exception as e:  # REPL: report, keep running
            say(f"error: {type(e).__name__}: {e}")
    return 0


def main(argv=None):
    ap = argparse.ArgumentParser(prog="tiflash-jax")
    ap.add_argument("--tpch-sf", type=float, default=0.01)
    ap.add_argument("--tbl-dir", help="load dbgen .tbl files instead of generating")
    ap.add_argument("--tables", default=None, help="comma-separated table subset")
    ap.add_argument("--distributed", action="store_true")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("tables", help="list catalog tables")

    q = sub.add_parser("query", help="execute a JSON plan file")
    q.add_argument("plan_file")
    q.add_argument("--limit", type=int, default=20, help="rows to print")
    q.add_argument("--summary", action="store_true")

    s = sub.add_parser("serve", help="run the HTTP query service")
    s.add_argument("--port", type=int, default=8123)

    sub.add_parser("metrics", help="dump metrics counters")

    r = sub.add_parser("repl", help="interactive JSON-plan REPL")
    r.add_argument("--limit", type=int, default=20)

    args = ap.parse_args(argv)
    if args.cmd in ("query", "serve", "repl"):
        from .runtime.device import enable_compile_cache

        enable_compile_cache()

    if args.cmd == "metrics":
        from .runtime.metrics import METRICS

        print(json.dumps(METRICS.dump(), indent=2))
        return 0

    cat = _build_catalog(args)

    if args.cmd == "tables":
        for name, t in cat.tables.items():
            cols = ", ".join(f"{c}:{d!r}" for c, d in t.schema.items())
            print(f"{name}  rows={t.row_count}  [{cols}]")
        return 0

    if args.cmd == "query":
        from .plan import serde
        from .runtime.executor import run_query

        with open(args.plan_file) as f:
            plan = serde.plan_from_json(json.load(f))
        out, summary = run_query(plan, cat.blocks(), mesh=_mesh(args))
        _print_block(out, args.limit)
        if args.summary:
            print(summary.pretty(), file=sys.stderr)
        return 0

    if args.cmd == "repl":
        return _repl(cat, _mesh(args), args.limit)

    if args.cmd == "serve":
        from .mpp.service import QueryService, serve_background

        svc = QueryService(cat, mesh=_mesh(args))
        httpd, port = serve_background(svc, args.port)
        print(f"serving on http://127.0.0.1:{port}  (Ctrl-C to stop)")
        try:
            import time

            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            httpd.shutdown()
        return 0


if __name__ == "__main__":
    sys.exit(main())
