"""Query serving runtime, ported from ``suffix_tpu/serve.py``.

The reference is a library; serving at scale needs a process that owns
the device-resident index and turns many concurrent small requests into
few large device dispatches. On CUDA one batched dispatch costs launches,
copies and a synchronising readback whether it carries 8 queries or 65k,
so coalescing is what lets a client see the card's batch rate, while
single queries and small batches take the native host route in
microseconds (table.py hybrid routing).

Components:

- ``Batcher`` — cross-request micro-batching: requests enqueue query
  lists and block on a future; a flusher drains the queue whenever
  ``max_batch`` queries are pending or the oldest request has waited
  ``max_wait_ms``, answering the whole drain with ONE bounds dispatch.
- ``serve_stdio`` — JSONL request/response over stdin/stdout, one
  request per line (the simplest thing an orchestrator can drive).
- ``serve_tcp`` — the same protocol over a TCP socket, one thread per
  connection, all connections sharing the Batcher (concurrent clients
  coalesce into shared dispatches).

Protocol (one JSON object per line):

    {"id": 1, "op": "positions", "q": "quick"}
    {"id": 2, "op": "count", "q": ["quick", "fox"]}

ops: positions | count | contains | any_position | info | ping.
``q`` is a string or list of strings; binary queries use ``q_b64``
(base64, string or list). Responses echo ``id`` and carry ``result``
(per-query list when the request was a list) or ``error``.
"""

from __future__ import annotations

import base64
import json
import sys
import threading
import time

import numpy as np

# Largest accepted JSONL request line (TCP): bounds memory per connection
# against unterminated streams. 16 MiB comfortably fits MAX_QUERY_BATCH
# b64-encoded queries; oversized lines drop the connection (framing lost).
MAX_LINE = 1 << 24


class _Pending:
    __slots__ = ("queries", "event", "starts", "counts", "error")

    def __init__(self, queries):
        self.queries = queries
        self.event = threading.Event()
        self.starts = None
        self.counts = None
        self.error = None


class Batcher:
    """Coalesce concurrent bounds requests into single device dispatches.

    ``submit`` blocks until the request's queries were part of a flushed
    batch and returns (starts, counts) for exactly those queries.
    """

    def __init__(self, table, max_batch: int = 65536, max_wait_ms: float = 2.0):
        self._table = table
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1e3
        self._lock = threading.Lock()
        self._queue: list[_Pending] = []
        self._queued = 0
        self._wake = threading.Condition(self._lock)
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def submit(self, queries) -> tuple[np.ndarray, np.ndarray]:
        if not queries:
            return np.empty(0, np.int64), np.empty(0, np.int64)
        p = _Pending(queries)
        with self._wake:
            if self._stop:  # racing past close(): the flusher is gone
                raise RuntimeError("batcher closed")
            self._queue.append(p)
            self._queued += len(queries)
            self._wake.notify()
        p.event.wait()
        if p.error is not None:
            raise p.error
        return p.starts, p.counts

    def close(self):
        with self._wake:
            self._stop = True
            self._wake.notify()
        self._thread.join(timeout=5)

    # ------------------------------------------------------------- internal

    def _run(self):
        while True:
            with self._wake:
                while not self._queue and not self._stop:
                    self._wake.wait()
                if self._stop and not self._queue:
                    return
                # Collect until max_batch pending or max_wait elapsed
                # since this drain started.
                deadline = time.monotonic() + self._max_wait
                while self._queued < self._max_batch and not self._stop:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._wake.wait(timeout=remaining)
                drain, self._queue = self._queue, []
                self._queued = 0
            try:  # the WHOLE drain body: a waiter must never hang
                flat = [q for p in drain for q in p.queries]
                starts, counts = self._table._bounds_batch(flat)
                off = 0
                for p in drain:
                    k = len(p.queries)
                    p.starts = np.asarray(starts[off:off + k])
                    p.counts = np.asarray(counts[off:off + k])
                    off += k
            except BaseException as e:  # propagate to every waiter
                for p in drain:
                    p.error = e
            finally:
                for p in drain:
                    p.event.set()


def _decode_queries(req):
    """-> (list_of_queries, was_list). Rejects non-string entries — a JSON
    number would otherwise coerce (bytes(3) == three NULs) and answer a
    different question than the client asked."""
    if "q" in req:
        q = req["q"]
        items, was_list = (q, True) if isinstance(q, list) else ([q], False)
        for x in items:
            if not isinstance(x, str):
                raise ValueError(f"'q' entries must be strings, got "
                                 f"{type(x).__name__}")
        return items, was_list
    if "q_b64" in req:
        q = req["q_b64"]
        items, was_list = (q, True) if isinstance(q, list) else ([q], False)
        out = []
        for x in items:
            if not isinstance(x, str):
                raise ValueError(f"'q_b64' entries must be base64 strings, "
                                 f"got {type(x).__name__}")
            out.append(base64.b64decode(x))
        return out, was_list
    raise ValueError("request needs 'q' or 'q_b64'")


def handle_request(table, batcher: Batcher | None, req: dict) -> dict:
    """Answer one protocol request (shared by stdio and tcp servers)."""
    rid = req.get("id")
    op = req.get("op", "positions")
    try:
        if op == "ping":
            return {"id": rid, "result": "pong"}
        if op == "info":
            return {"id": rid, "result": {"bytes": table.len()}}
        if op not in ("positions", "count", "contains", "any_position"):
            return {"id": rid, "error": f"unknown op: {op}"}
        queries, was_list = _decode_queries(req)
        if not queries:  # 'q': [] — answer [] without any dispatch
            return {"id": rid, "result": []}
        if batcher is not None:
            starts, counts = batcher.submit(queries)
        else:
            starts, counts = table._bounds_batch(queries)
        tab = table.table()
        if op == "positions":
            out = [tab[int(s): int(s) + int(c)].tolist()
                   for s, c in zip(starts, counts)]
        elif op == "count":
            out = [int(c) for c in counts]
        elif op == "contains":
            out = [bool(c > 0) for c in counts]
        elif op == "any_position":
            out = [int(tab[int(s)]) if int(c) else None
                   for s, c in zip(starts, counts)]
        return {"id": rid, "result": out if was_list else out[0]}
    except Exception as e:
        return {"id": rid, "error": f"{type(e).__name__}: {e}"}


def serve_stdio(table, batcher: Batcher | None = None,
                infile=None, outfile=None) -> None:
    """One JSONL request per stdin line; EOF or "quit" op terminates."""
    infile = infile or sys.stdin
    outfile = outfile or sys.stdout
    for line in infile:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            print(json.dumps({"error": f"bad json: {e}"}), file=outfile,
                  flush=True)
            continue
        if req.get("op") == "quit":
            print(json.dumps({"id": req.get("id"), "result": "bye"}),
                  file=outfile, flush=True)
            return
        print(json.dumps(handle_request(table, batcher, req)), file=outfile,
              flush=True)


def serve_tcp(table, port: int, host: str = "127.0.0.1",
              batcher: Batcher | None = None, ready_event=None,
              max_conns: int = 128):
    """Threaded JSONL-over-TCP server; all connections share ``batcher``.

    Blocks serving until the process is killed or the server is shut
    down. Once it listens, the bound (host, port) goes to stderr and, when
    ``ready_event`` is given, the server is attached to it as
    ``ready_event.server`` before it is set: its ``server_address`` is
    the bound address (port 0 picks a free one) and its ``shutdown()``
    stops the loop. Intended to be the long-lived index owner: clients
    coalesce through the Batcher into shared device dispatches.
    """
    import socketserver

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            while True:
                raw = self.rfile.readline(MAX_LINE + 1)
                if not raw:
                    return
                if len(raw) > MAX_LINE:  # unterminated/oversized line:
                    # protocol framing is lost — report and drop the conn.
                    self.wfile.write((json.dumps(
                        {"error": f"line exceeds {MAX_LINE} bytes"})
                        + "\n").encode())
                    return
                line = raw.decode("utf-8", errors="replace").strip()
                if not line:
                    continue
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    resp = {"error": f"bad json: {e}"}
                else:
                    if req.get("op") == "quit":
                        self.wfile.write(
                            (json.dumps({"id": req.get("id"),
                                         "result": "bye"}) + "\n").encode())
                        return
                    resp = handle_request(table, batcher, req)
                self.wfile.write((json.dumps(resp) + "\n").encode())

    class Server(socketserver.ThreadingTCPServer):
        allow_reuse_address = True
        daemon_threads = True
        request_queue_size = max_conns

    with Server((host, port), Handler) as srv:
        if ready_event is not None:
            ready_event.server = srv
            ready_event.set()
        print(f"serving on {srv.server_address[0]}:{srv.server_address[1]}",
              file=sys.stderr, flush=True)
        srv.serve_forever()
