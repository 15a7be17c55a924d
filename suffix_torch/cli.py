"""Command-line interface, ported from ``suffix_tpu/cli.py``: the same
subcommands, options, defaults and standard output.

Mirrors the reference's two binaries:

- ``suffix-array <file>`` (src/main.rs:8-15): build an index over a file and
  print ``Suffixes: {n}``, the reference's end-to-end throughput harness.
  Here: ``python -m suffix_torch build <file>``.
- ``stree <text>...`` (stree_cmd/src/main.rs:58-86): join argv with spaces,
  build a suffix tree, emit GraphViz dot.
  Here: ``python -m suffix_torch stree <text>...``.

Plus ``search`` (batched queries against a file or a saved index),
``serve`` (the JSONL server of serve.py), ``info`` and ``warmup``.
``--platform`` picks the torch device: ``cuda`` (the default, which
raises without a card) or ``cpu``; env ``SUFFIX_TORCH_PLATFORM``.
``build --engine sharded``, ``search --sharded`` and ``warmup --devices N``
run over a process group: the caller's, or ``N`` ranks started for the
command (``parallel/launch.py``); rank 0 writes the output.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _cmd_build(args) -> int:
    from suffix_torch import SuffixTable

    try:
        with open(args.file, "rb") as f:
            data = f.read()
    except OSError as e:
        print(f"error: cannot read {args.file}: {e.strerror}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    if args.engine == "sharded":
        from suffix_torch.parallel import launch
        from suffix_torch.parallel.dist_build import build_table

        # Read from the file's mmap on every rank, block by block.
        sa = launch.run(build_table, args.devices, args.file,
                        args.checkpoint, args.resume, args.index_dtype,
                        device=args.device)
        if not launch.is_lead():
            return 0
        st = SuffixTable.from_parts(data, sa, device=args.device)
    elif args.engine == "naive":
        st = SuffixTable.new_naive(data, device=args.device)
    else:
        st = SuffixTable.new(data, engine=args.engine,
                             index_dtype=args.index_dtype,
                             collect_stats=args.stats, device=args.device)
    dt = time.perf_counter() - t0
    print(f"Suffixes: {st.len()}")
    if args.stats and st.build_stats is not None:
        from suffix_torch.utils.metrics import stats_json

        print(stats_json(st.build_stats))
    if args.verbose:
        mbps = len(data) / max(dt, 1e-9) / 1e6
        print(f"built in {dt:.3f}s ({mbps:.1f} MB/s)", file=sys.stderr)
    if args.output:
        from suffix_torch.utils.checkpoint import save_index

        save_index(args.output, st, build_stats=st.build_stats)
        print(f"index saved to {args.output}", file=sys.stderr)
    return 0


def _cmd_stree(args) -> int:
    from suffix_torch.tree.dot import to_dot

    text = " ".join(args.text)
    if args.array:
        # Array-native derivation (tree/atree.py): same dot output,
        # built as flat device arrays instead of the pointer fold.
        from suffix_torch import ArraySuffixTree as Tree
    else:
        from suffix_torch import SuffixTree as Tree
    sys.stdout.write(to_dot(Tree.new(text, device=args.device)))
    return 0


def _search_table(index: str | None, file: str | None, device):
    """The table ``search`` answers from: the saved index, else the
    file's."""
    from suffix_torch import SuffixTable
    from suffix_torch.utils.checkpoint import load_index

    if index:
        return load_index(index, device=device)
    with open(file, "rb") as f:
        return SuffixTable.new(f.read(), device=device)


def _sharded_positions(mesh, index: str | None, file: str | None,
                       queries: list):
    """One rank of ``search --sharded``: the rank reads the index or the
    file itself, then serves the batch from a ShardedQueryIndex."""
    from suffix_torch.parallel.dist_query import ShardedQueryIndex

    st = _search_table(index, file, mesh.device)
    idx = ShardedQueryIndex(st.text_bytes(), mesh, sa=st.table())
    return idx.positions_batch(queries)


def _cmd_search(args) -> int:
    if not (args.index or args.file):
        print("error: search requires --file or --index", file=sys.stderr)
        return 2
    if not args.index:
        try:
            open(args.file, "rb").close()
        except OSError as e:
            print(f"error: cannot read {args.file}: {e.strerror}",
                  file=sys.stderr)
            return 1
    queries = args.query
    if args.queries_file:
        with open(args.queries_file) as f:
            queries = queries + [ln.rstrip("\n") for ln in f if ln.strip()]
    if args.sharded:
        from suffix_torch.parallel import launch

        hits = launch.run(_sharded_positions, args.devices, args.index,
                          args.file, queries, device=args.device)
        if not launch.is_lead():
            return 0
    else:
        st = _search_table(args.index, args.file, args.device)
        hits = st.positions_batch(queries)
    for q, h in zip(queries, hits):
        print(f"{q}\t{len(h)}\t{','.join(map(str, sorted(h.tolist())))}")
    return 0


def _cmd_serve(args) -> int:
    from suffix_torch import SuffixTable
    from suffix_torch.serve import Batcher, serve_stdio, serve_tcp
    from suffix_torch.utils.checkpoint import load_index

    if args.index:
        st = load_index(args.index, device=args.device)
    elif args.file:
        with open(args.file, "rb") as f:
            st = SuffixTable.new(f.read(), engine="auto", device=args.device)
    else:
        print("error: serve requires --file or --index", file=sys.stderr)
        return 2
    if args.warm:
        # Run the batch query program once for EVERY shape bucket real
        # requests can hit, so no client pays a first call's allocations:
        # the full power-of-two batch ladder up to the serving cap (with
        # --batch, Batcher drains pad to any such bucket) crossed with the
        # 8/16/32/64-byte pattern-length buckets (>18 bytes also builds
        # the extended keys). Force the device route: warming the host
        # path is meaningless and small warm batches would otherwise be
        # diverted.
        prev_route = st.query_route
        st.query_route = "device"
        cap = min(args.max_batch if args.batch else st.MAX_QUERY_BATCH,
                  st.MAX_QUERY_BATCH)
        try:
            q_bucket = 8
            while q_bucket <= cap:
                for mlen in (7, 15, 31, 63):  # pads to 8/16/32/64 buckets
                    t0 = time.perf_counter()
                    st._bounds_batch(["a" * mlen] * q_bucket)
                    dt = time.perf_counter() - t0
                    if dt > 1.0:  # show slow first calls only
                        print(f"warmed q={q_bucket} m={mlen + 1}: {dt:.1f}s",
                              file=sys.stderr, flush=True)
                q_bucket *= 2
        finally:
            st.query_route = prev_route
    if args.batch and args.tcp is None:
        # stdio is strictly sequential: a batcher can never coalesce and
        # only adds max_wait_ms latency per request.
        print("warning: --batch has no effect over stdio; disabled",
              file=sys.stderr)
        args.batch = False
    batcher = Batcher(st, max_batch=args.max_batch,
                      max_wait_ms=args.max_wait_ms) if args.batch else None
    try:
        if args.tcp is not None:
            serve_tcp(st, args.tcp, host=args.host, batcher=batcher)
        else:
            serve_stdio(st, batcher=batcher)
    finally:
        if batcher is not None:
            batcher.close()
    return 0


def _cmd_info(args) -> int:
    from suffix_torch.utils.checkpoint import load_index

    st = load_index(args.index, device=args.device)
    lcp = st.lcp_lens()
    n = st.len()
    print(f"text bytes:   {n}")
    print(f"suffixes:     {n}")
    print(f"max lcp:      {int(lcp.max(initial=0))}")
    print(f"mean lcp:     {float(lcp.mean()) if n else 0.0:.2f}")
    # Distinct non-empty substrings = sum of (suffix length - lcp).
    print(f"distinct substrings: {n * (n + 1) // 2 - int(lcp.sum())}")
    if st.build_stats:
        from suffix_torch.utils.metrics import stats_json

        print(f"build stats:  {stats_json(st.build_stats)}")
    return 0


def _cmd_warmup(args) -> int:
    from suffix_torch.utils.warmup import warm, warm_sharded

    if args.devices > 1:
        timings = warm_sharded(args.size, args.devices, device=args.device)
    else:
        timings = warm(
            args.size,
            query_batches=tuple(int(x) for x in args.batches.split(",")),
            query_lens=tuple(int(x) for x in args.qlens.split(",")),
            lcp=not args.no_lcp,
            device=args.device,
        )
    total = sum(dt for _, dt in timings)
    print(f"warmed {len(timings)} programs in {total:.1f}s")
    return 0


def _resolve_platform(platform: str | None) -> str:
    """The torch device type every command runs on: ``--platform``, else
    env SUFFIX_TORCH_PLATFORM, else ``cuda``; raises when that is CUDA
    and there is no card (``device.resolve_device``)."""
    from suffix_torch.device import resolve_device

    platform = platform or os.environ.get("SUFFIX_TORCH_PLATFORM") or "cuda"
    return resolve_device(platform).type


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="suffix-torch",
                                description="Suffix-array toolkit on "
                                            "PyTorch (CUDA or CPU)")
    p.add_argument("--platform", choices=["cuda", "cpu"],
                   help="torch device (default: env SUFFIX_TORCH_PLATFORM, "
                        "else cuda)")
    sub = p.add_subparsers(dest="cmd", required=True)

    b = sub.add_parser("build", help="build a suffix index over a file")
    b.add_argument("file")
    b.add_argument("-o", "--output", help="save the index (npz checkpoint)")
    b.add_argument("-v", "--verbose", action="store_true")
    b.add_argument("-e", "--engine", default="auto",
                   choices=["auto", "device", "sais", "native", "naive",
                            "sharded"],
                   help="construction engine (auto = native CPU for small "
                        "files, device otherwise; sharded = over --devices "
                        "ranks)")
    b.add_argument("--devices", type=int, default=None,
                   help="ranks for --engine sharded (default: one a card, "
                        "or one on the CPU)")
    b.add_argument("--checkpoint",
                   help="sharded: persist per-round state for elastic restart")
    b.add_argument("--resume", action="store_true",
                   help="sharded: resume from --checkpoint if present")
    b.add_argument("--index-dtype", default="u32",
                   choices=["u32", "u64", "auto"],
                   help="u64 lifts the 2^31-byte cap (int64 indices on the "
                        "device)")
    b.add_argument("--stats", action="store_true",
                   help="instrumented build: print one JSON line of "
                        "structured metrics (engine, rounds, tie-mass "
                        "trajectory, bytes/s) and save it with -o")
    b.set_defaults(fn=_cmd_build)

    s = sub.add_parser("stree", help="print a suffix tree as GraphViz dot")
    s.add_argument("text", nargs="*")
    s.add_argument("--array", action="store_true",
                   help="build via the array-native device derivation")
    s.set_defaults(fn=_cmd_stree)

    q = sub.add_parser("search", help="batched substring search")
    q.add_argument("--file", help="text file to index")
    q.add_argument("--index", help="pre-built index checkpoint (npz)")
    q.add_argument("--queries-file", help="file with one query per line")
    q.add_argument("--sharded", action="store_true",
                   help="serve from a sharded index (over --devices "
                        "ranks)")
    q.add_argument("--devices", type=int, default=None,
                   help="mesh size for --sharded (default: all)")
    q.add_argument("query", nargs="*")
    q.set_defaults(fn=_cmd_search)

    v = sub.add_parser("serve",
                       help="long-lived query server (JSONL stdio or TCP)")
    v.add_argument("--file", help="text file to index at startup")
    v.add_argument("--index", help="pre-built index checkpoint (npz)")
    v.add_argument("--tcp", type=int, default=None, metavar="PORT",
                   help="serve JSONL over TCP (default: stdio)")
    v.add_argument("--host", default="127.0.0.1")
    v.add_argument("--batch", action="store_true",
                   help="coalesce concurrent requests into shared dispatches")
    v.add_argument("--max-batch", type=int, default=65536)
    v.add_argument("--max-wait-ms", type=float, default=2.0)
    v.add_argument("--warm", action="store_true",
                   help="run the batched query program once per shape "
                        "bucket at startup")
    v.set_defaults(fn=_cmd_serve)

    i = sub.add_parser("info", help="statistics of a saved index")
    i.add_argument("index", help="index checkpoint (npz)")
    i.set_defaults(fn=_cmd_info)

    w = sub.add_parser("warmup",
                       help="run the serving pipeline once for a size")
    w.add_argument("--size", type=int, required=True,
                   help="corpus size in bytes (shapes bucket to pow2)")
    w.add_argument("--batches", default="4096,65536",
                   help="query batch sizes, comma-separated")
    w.add_argument("--qlens", default="16",
                   help="padded query lengths, comma-separated")
    w.add_argument("--no-lcp", action="store_true")
    w.add_argument("--devices", type=int, default=1,
                   help="warm the sharded build for this mesh size instead "
                        "of the single-card pipeline")
    w.set_defaults(fn=_cmd_warmup)

    args = p.parse_args(argv)
    args.device = _resolve_platform(args.platform)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
