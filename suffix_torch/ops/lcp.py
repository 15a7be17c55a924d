"""LCP arrays, in PyTorch.

Port of ``suffix_tpu/ops/lcp.py``. Contract (reference
src/table.rs:348-361): ``lcp[0] = 0`` and ``lcp[i]`` is the number of
equal leading bytes of the suffixes at ranks i-1 and i.

The device route reads the first 18 bytes of every adjacent pair from the
packed rank-order prefix keys (no gathers), then refines the few pairs
equal through all of them ("survivors") with windowed byte compares, in
chunks of 2048 lanes. ``lcp_from_sa(method="auto")`` routes survivor-
dense corpora to the linear host Kasai, with the JAX package's
thresholds, so both packages take the same route.

What changes from JAX to PyTorch:

- ``lax.while_loop`` becomes a host loop with one readback per round.
- Survivor compaction is ``nonzero`` (a stable compaction) and the
  un-permute is a scatter, where JAX key-sorts both ways.
- ``cumprod(eq).sum(axis=1)`` (equal leading bytes of a window) is a
  first-mismatch ``argmax``.
- The native C++ Kasai is not ported, so the Kasai route is the host
  numpy ``kasai_host`` (JAX's own route when its native library is
  missing), and the staged bulk engine (``_lcp_bulk``) raises
  ``NotImplementedError``.
"""

from __future__ import annotations

import numpy as np
import torch

from suffix_torch.device import resolve_device
from suffix_torch.ops import search2
from suffix_torch.ops.padding import PAD, bucket_size

I32 = torch.int32

# Routing thresholds, copied from the JAX package.
LCP_SURV_CHUNKED = 2048      # one refine chunk
LCP_MAX_OFF = 8192           # chunked path: ~64 refine rounds of 128 B
LCP_SAMPLE_DENSE_FRAC = 2 / 64
LCP_SAMPLE_K = 1 << 16


def _window(text: torch.Tensor, n_text: int, base: torch.Tensor, off: int,
            width: int) -> torch.Tensor:
    """(lanes, width) bytes text[base + off + j], PAD at and past
    ``n_text``."""
    pos = (base.long() + off)[:, None] + torch.arange(
        width, device=text.device)[None, :]
    w = text[torch.clamp(pos, max=text.shape[0] - 1)]
    return torch.where(pos < n_text, w, PAD)


def _equal_run(wa: torch.Tensor, wb: torch.Tensor) -> torch.Tensor:
    """Number of equal leading entries of each row pair, int32."""
    ne = wa != wb
    first = ne.to(torch.uint8).argmax(dim=1).to(I32)
    return torch.where(ne.any(dim=1), first, wa.shape[1])


def _lcp_padded(text: torch.Tensor, n_text: int, table: torch.Tensor,
                n_table: int, block: int = 128) -> torch.Tensor:
    """LCP of a padded table by windowed compares over every pair; entry
    0 and padded entries are 0."""
    n_pad = table.shape[0]
    prev = torch.cat([table[:1], table[:-1]])
    idx = torch.arange(n_pad, device=table.device)
    active0 = (idx > 0) & (idx < n_table)
    lcp = torch.zeros((n_pad,), dtype=I32, device=table.device)
    active = active0
    off = 0
    while bool(active.any()):
        run = _equal_run(_window(text, n_text, prev, off, block),
                         _window(text, n_text, table, off, block))
        lcp = torch.where(active, lcp + run, lcp)
        # The off guard ends the loop on duplicate table entries too.
        active = active & (run == block) & (off + block < n_text)
        off += block
    return torch.where(active0 | (idx == 0), lcp, 0)


def _survivor_count(pk, n_table: int) -> int:
    """Adjacent valid rank pairs equal through all packed key words."""
    n_pad = pk[0].shape[0]
    idx = torch.arange(n_pad, device=pk[0].device)
    eq = (idx > 0) & (idx < n_table)
    for word in pk:
        eq = eq & (word == torch.cat([word[:1], word[:-1]]))
    return int(eq.sum())


def _keyed_base(pk, n_table: int):
    """(lcp, undecided, valid): per-pair LCP over the first KEY_SYMS bytes
    from the packed keys, and the pairs equal through all of them."""
    n_pad = pk[0].shape[0]
    idx = torch.arange(n_pad, device=pk[0].device)
    valid = (idx > 0) & (idx < n_table)
    lcp = torch.zeros((n_pad,), dtype=I32, device=pk[0].device)
    undecided = valid
    for word in pk:
        prev = torch.cat([word[:1], word[:-1]])
        eq_word = word == prev
        # First differing symbol inside the word (3 x 9 bits, most
        # significant first). A 0 (past the end) symbol on one side
        # mismatches the other's real byte, so matched counts real bytes.
        s_cur = [(word >> (18 - 9 * j)) & 0x1FF for j in range(2)]
        s_prv = [(prev >> (18 - 9 * j)) & 0x1FF for j in range(2)]
        within = torch.where(s_cur[0] != s_prv[0], 0,
                             torch.where(s_cur[1] != s_prv[1], 1, 2))
        matched = torch.where(eq_word, 3, within).to(I32)
        lcp = torch.where(undecided, lcp + matched, lcp)
        undecided = undecided & eq_word
    return lcp, undecided, valid


def _lcp_keyed(text: torch.Tensor, n_text: int, table: torch.Tensor,
               n_table: int, pk, block: int = 128, max_off: int = 0):
    """(lcp, unresolved): LCP via the packed rank-order prefix keys, the
    survivors refined by ``block``-byte window rounds in chunks of
    2048 lanes. ``max_off`` > 0 stops a chunk at that byte offset; the
    lanes it leaves active are counted in ``unresolved``."""
    n_pad = table.shape[0]
    idx = torch.arange(n_pad, device=table.device)
    lcp, undecided, valid = _keyed_base(pk, n_table)
    prev_t = torch.cat([table[:1], table[:-1]])
    surv = torch.nonzero(undecided).flatten()
    cap = min(n_pad, 2048)
    unresolved = 0
    for c0 in range(0, surv.shape[0], cap):
        lanes = surv[c0:c0 + cap]
        ca, cp, cl = table[lanes], prev_t[lanes], lcp[lanes]
        active = torch.ones_like(lanes, dtype=torch.bool)
        off = search2.KEY_SYMS
        while bool(active.any()) and not (max_off and off >= max_off):
            run = _equal_run(_window(text, n_text, cp, off, block),
                             _window(text, n_text, ca, off, block))
            cl = torch.where(active, cl + run, cl)
            active = active & (run == block) & (off + block < n_text)
            off += block
        lcp[lanes] = cl
        unresolved += int(active.sum())
    return torch.where(valid | (idx == 0), lcp, 0), unresolved


def _kasai_route(text_bytes: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Linear-time host route for the auto fallback (numpy; the native
    C++ Kasai is not ported, ROADMAP.md Queue 1 item 4)."""
    return kasai_host(text_bytes, sa)


def _sampled_survivor_rate(t_np: np.ndarray, sa: np.ndarray,
                           k: int = LCP_SAMPLE_K) -> float:
    """Estimated fraction of adjacent SA pairs sharing >= KEY_SYMS bytes,
    from ``k`` sampled ranks on the host. Pairs where a suffix ends inside
    the window count as survivors (conservative)."""
    n = int(sa.shape[0])
    if n < 2:
        return 0.0
    k = min(k, n - 1)
    rng = np.random.default_rng(0x5A17)
    ranks = rng.integers(1, n, size=k)
    offs = np.arange(search2.KEY_SYMS, dtype=np.int64)
    a = sa[ranks].astype(np.int64)[:, None] + offs
    b = sa[ranks - 1].astype(np.int64)[:, None] + offs
    in_a = a < n
    in_b = b < n
    wa = t_np[np.minimum(a, n - 1)]
    wb = t_np[np.minimum(b, n - 1)]
    eq = (wa == wb) & in_a & in_b
    surv = np.all(eq | ~in_a | ~in_b, axis=1)
    return float(surv.mean())


def lcp_from_sa(text_bytes: np.ndarray, sa: np.ndarray, block: int = 128,
                pk=None, method: str = "auto", device=None) -> np.ndarray:
    """LCP array (uint32) of ``text_bytes`` and its SA, on ``device``
    (``None`` = CUDA).

    ``method="auto"`` routes by the survivor census, as the JAX package
    does: at most LCP_SURV_CHUNKED survivors -> the chunked keyed refine
    with a LCP_MAX_OFF budget (Kasai if lanes stay unresolved); else at
    most n/64 -> the bulk engine, not ported (``NotImplementedError``;
    below 2^17 bytes n/64 < LCP_SURV_CHUNKED, so it is never taken);
    else the host Kasai. A corpus of >= 2^20 bytes without ``pk``
    is first sampled on the host and sent to Kasai when clearly dense.
    ``method="device"`` runs the unbounded keyed refine.

    ``pk``: the table's flat rank-order key words, when its query index
    exists (else they are built here)."""
    n = int(sa.shape[0])
    if n == 0:
        return np.empty((0,), dtype=np.uint32)
    dev = resolve_device(device)
    n_pad = bucket_size(n)
    t_np = np.asarray(text_bytes, dtype=np.uint8)
    if method == "auto" and pk is None and n >= (1 << 20):
        if _sampled_survivor_rate(t_np, sa) > LCP_SAMPLE_DENSE_FRAC:
            return _kasai_route(t_np, sa)
    t_pad = np.full((n_pad,), PAD, dtype=np.int32)
    t_pad[:n] = t_np
    sa_pad = np.zeros((n_pad,), dtype=np.int32)
    sa_pad[:n] = sa
    t_dev = torch.from_numpy(t_pad).to(dev)
    tab_dev = torch.from_numpy(sa_pad).to(dev)
    if pk is None:
        pk = search2.packed_keys_rank_order(t_dev, tab_dev, n)
    if method == "auto":
        n_surv = _survivor_count(pk, n)
        if n_surv <= LCP_SURV_CHUNKED:
            out, unresolved = _lcp_keyed(t_dev, n, tab_dev, n, pk,
                                         block=block, max_off=LCP_MAX_OFF)
            if unresolved > 0:
                return _kasai_route(t_np, sa)
        elif n_surv <= n // 64:
            raise NotImplementedError(
                f"{n_surv} LCP survivors route to the staged bulk engine "
                "(_lcp_bulk), which is not ported to suffix_torch yet; see "
                "ROADMAP.md Queue 1 item 10")
        else:
            return _kasai_route(t_np, sa)
    elif method == "device":
        out, _ = _lcp_keyed(t_dev, n, tab_dev, n, pk, block=block)
    else:
        raise ValueError(f"unknown LCP method: {method!r}")
    return out[:n].cpu().numpy().astype(np.uint32)


def kasai_host(text_bytes: np.ndarray, sa: np.ndarray) -> np.ndarray:
    """Linear-time Kasai LCP on the host (numpy scalar loop), over raw
    bytes: the test oracle and the auto route's fallback."""
    t = np.asarray(text_bytes, dtype=np.uint8)
    n = int(sa.shape[0])
    lcp = np.zeros(n, dtype=np.uint32)
    if n == 0:
        return lcp
    rank = np.zeros(n, dtype=np.int64)
    rank[sa.astype(np.int64)] = np.arange(n)
    h = 0
    for i in range(n):
        r = rank[i]
        if r == 0:
            h = 0
            continue
        j = int(sa[r - 1])
        while i + h < n and j + h < n and t[i + h] == t[j + h]:
            h += 1
        lcp[r] = h
        if h > 0:
            h -= 1
    return lcp
