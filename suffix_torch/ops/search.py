"""Query primitives: the byte comparison of a suffix with a query, the
windowed binary-search engine (``bounds_batch``), both written batched
over rows, and query packing.

Port of ``suffix_tpu/ops/search.py``. Reference semantics
(src/table.rs:197-293): ``positions`` is the SA slice
``table[start:end]`` in SA order; an empty query or text matches nothing.
"""

from __future__ import annotations

import numpy as np
import torch

from suffix_torch.ops.padding import PAD


def _cmp_suffix_query(text: torch.Tensor, n_text: int, sufi: torch.Tensor,
                      queries: torch.Tensor, qlens: torch.Tensor):
    """Compare suffix(text, sufi[r]) with queries[r, :qlens[r]] per row.

    Returns (lt_full, gt_prefix), bool ``(Q,)``:
      lt_full   — suffix <  query under full comparison (a proper-prefix
                  suffix is smaller: sentinel PAD < any byte).
      gt_prefix — suffix[:qlen] > query under prefix comparison (equality
                  through qlen bytes means "starts with", NOT greater).
    """
    m = queries.shape[1]
    cols = torch.arange(m, dtype=torch.int32, device=queries.device)
    offs = sufi[:, None] + cols[None, :]
    live = (offs >= 0) & (offs < min(n_text, text.shape[0]))
    window = torch.where(
        live, text[torch.clamp(offs, 0, text.shape[0] - 1).long()], PAD)
    return _cmp_window(window, queries, qlens)


def _cmp_window(window: torch.Tensor, queries: torch.Tensor,
                qlens: torch.Tensor):
    """``_cmp_suffix_query`` on suffix windows already fetched: ``window``
    is ``(Q, m)``, the suffix's first m bytes with PAD past the text."""
    m = queries.shape[1]
    cols = torch.arange(m, dtype=torch.int32, device=queries.device)
    # First byte mismatch within each query's live range (m if none).
    neq = (window != queries) & (cols[None, :] < qlens[:, None])
    first = torch.where(neq, cols[None, :], m).min(dim=1).values
    any_neq = first < m
    at = torch.clamp(first, max=m - 1).long()[:, None]
    w_at = window.gather(1, at)[:, 0]
    q_at = queries.gather(1, at)[:, 0]
    return any_neq & (w_at < q_at), any_neq & (w_at > q_at)


def _table_at(table: torch.Tensor, mid: torch.Tensor) -> torch.Tensor:
    """table[mid] as int32, 0 where ``mid`` lies past the table (JAX's
    ``take(mode="fill", fill_value=0)``)."""
    n_tab = table.shape[0]
    got = table[torch.clamp(mid, 0, n_tab - 1).long()]
    return torch.where((mid >= 0) & (mid < n_tab), got, 0).to(torch.int32)


def bounds_batch(text: torch.Tensor, n_text: int, table: torch.Tensor,
                 n_table: int, queries: torch.Tensor, qlens: torch.Tensor,
                 n_iters: int):
    """(start, count) int32 per row of a (Q, m) padded query batch.

    Two fixed-trip branchless binary searches of ``n_iters`` probes
    (``ceil(log2(n + 1))`` covers the table), all rows in lockstep; each
    probe gathers an m-byte window of the text per row. The lower bound
    is the first suffix >= query (full comparison), the upper the first
    suffix > query under prefix comparison, searched from the lower."""
    n_q = queries.shape[0]
    dev = queries.device

    def search(left, upper: bool):
        right = torch.full((n_q,), n_table, dtype=torch.int32, device=dev)
        for _ in range(n_iters):
            active = left < right
            mid = (left + right) // 2
            lt, gt = _cmp_suffix_query(text, n_text, _table_at(table, mid),
                                       queries, qlens)
            # lower: query <= suffix; upper: suffix > query[:qlen]
            go_left = gt if upper else ~lt
            left = torch.where(active & ~go_left, mid + 1, left)
            right = torch.where(active & go_left, mid, right)
        return left

    start = search(torch.zeros((n_q,), dtype=torch.int32, device=dev), False)
    end = search(start, True)
    empty = (qlens == 0) | (n_table == 0)
    start = torch.where(empty, 0, start)
    end = torch.where(empty, 0, end)
    return start, torch.clamp(end - start, min=0)


def pack_queries(queries, pad_to: int | None = None):
    """Encode a list of str/bytes queries into (Q, m) int32 + lengths."""
    bs = [q.encode("utf-8") if isinstance(q, str) else bytes(q) for q in queries]
    m = max([len(b) for b in bs] + [1])
    if pad_to is not None:
        m = max(m, pad_to)
    out = np.full((len(bs), m), PAD, dtype=np.int32)
    lens = np.zeros((len(bs),), dtype=np.int32)
    for i, b in enumerate(bs):
        if b:
            out[i, : len(b)] = np.frombuffer(b, dtype=np.uint8)
        lens[i] = len(b)
    return out, lens
