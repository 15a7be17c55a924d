"""Array-native suffix tree, ported from ``suffix_tpu/tree/atree.py``.

The pointer-object fold (tree/stree.py, mirroring the reference's
suffix_tree/src/lib.rs:392-505) walks ranks one at a time on the host,
which caps the tree at toy sizes. This module derives the SAME tree as
flat arrays in one device program over (SA, LCP), torch operations on the
table's device:

- Internal nodes are exactly the lcp-intervals of the LCP array: for
  every rank i with d = lcp[i] >= 1, the maximal interval [l, r] with
  ``lcp[l] < d``, ``min(lcp[l+1..r]) >= d``, ``lcp[r+1] < d`` is a node
  of path depth d. PSV/NSV (previous/next smaller value) give (l, r)
  per position by binary lifting over a sparse range-min table
  (log n vectorized rounds, no sequential stack, no 1-D scan); one sort
  on (l, d), with the position as the tie-break, dedups (l, d) pairs
  into node ids.
- The parent of node (l, d, r) is the interval of position
  p = argmax(lcp[l], lcp[r+1]) (the standard enhanced-suffix-array
  parent rule); leaves attach at depth max(lcp[i], lcp[i+1]).
- A suffix whose length equals its attachment depth terminates INSIDE
  that node (the reference fold's semantics for prefix suffixes:
  nodes carry terminal lists, see suffix_tree/src/lib.rs:421-441);
  every other rank is a leaf child.
- Label offsets reproduce the fold's byte-for-byte, including WHICH
  occurrence each internal label slices (the fold re-labels a node
  when a later rank splits its in-edge: offsets come from table[r]
  when the parent boundary is on the right, from table[rep-1]
  otherwise, rep = first position of the interval's lcp value).

Every array equals the JAX package's element for element. Gathers clamp
their int64 indices to [0, n_pad) (JAX's ``mode="clip"``); scatters whose
slot may be n_pad (JAX's ``mode="drop"``) write into an n_pad + 1 buffer
and slice the extra slot off. The Node API stays available as a lazy
host view (ANode) over the arrays, so the dot renderer (tree/dot.py) and
every iterator family work unchanged.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from suffix_torch.ops.padding import bucket_size
from suffix_torch.ops.sort import lexsort
from suffix_torch.table import SuffixTable

I32 = torch.int32
BIG = 0x7FFFFFFF  # range-min fill past the end: above every LCP


def tree_arrays(sa_pad: torch.Tensor, lcp_pad: torch.Tensor,
                n: int) -> dict:
    """All tree arrays from the padded SA and LCP (int32, one device).

    ``lcp_pad`` carries -1 beyond rank n-1 so smaller-value searches stop
    at the text boundary. Returns per-node arrays (``node_*``, n_pad long,
    the first ``m`` valid, sentinel -2 after) and per-rank leaf data
    (``leaf_parent``, ``leaf_start``, ``is_term``), as tensors on the
    input's device, and ``m`` as an int.
    """
    n_pad = lcp_pad.shape[0]
    dev = lcp_pad.device
    idx = torch.arange(n_pad, dtype=I32, device=dev)
    K = max(1, int(n_pad - 1).bit_length())

    def full(fill, size=n_pad):
        return torch.full((size,), fill, dtype=I32, device=dev)

    def take(arr, pos):
        return arr[pos.clamp(0, n_pad - 1).long()]

    def scatter_drop(fill, slot, vals):
        out = full(fill, n_pad + 1)
        out[slot.long()] = vals
        return out[:n_pad]

    # Sparse range-min table: mins[k][i] = min lcp over [i, i+2^k).
    mins = [lcp_pad]
    for k in range(1, K + 1):
        half = 1 << (k - 1)
        shifted = torch.cat([mins[-1][half:], full(BIG, half)])
        mins.append(torch.minimum(mins[-1], shifted))

    d = lcp_pad

    # NSV(i): first j > i with lcp[j] < lcp[i] (lcp pad = -1 bounds the
    # search at n). Binary lifting, all positions in lockstep.
    pos = idx + 1
    for k in range(K, -1, -1):
        step = 1 << k
        can = (pos + step <= n_pad) & (take(mins[k], pos) >= d)
        pos = torch.where(can, pos + step, pos)
    nsv = torch.clamp(pos, max=n)

    # PSV(i): last j < i with lcp[j] < lcp[i] (lcp[0] = 0 bounds it).
    pos = idx
    for k in range(K, -1, -1):
        step = 1 << k
        can = (pos - step >= 0) & (take(mins[k], pos - step) >= d)
        pos = torch.where(can, pos - step, pos)
    psv = torch.clamp(pos - 1, min=0)
    del mins

    # Interval keys per position (ranks 1..n-1 with depth >= 1). The
    # stable sort keeps equal (l, d) rows in position order, so the
    # position is the third key, as in JAX's three-key sort.
    has_node = (idx >= 1) & (idx < n) & (d >= 1)
    l_key = torch.where(has_node, psv, n_pad)
    d_key = torch.where(has_node, d, n_pad)
    s_l, s_d, s_i = lexsort((l_key, d_key), (idx,))
    prev_l = torch.cat([full(-1, 1), s_l[:-1]])
    prev_d = torch.cat([full(-1, 1), s_d[:-1]])
    valid_row = s_l < n_pad
    first = valid_row & ((s_l != prev_l) | (s_d != prev_d))
    gid_sorted = torch.cumsum(first, 0, dtype=I32) - 1
    m = int(first.sum())
    # Per-position node id, scattered back through the sort payload.
    pos2node = full(-2)
    pos2node[s_i.long()] = torch.where(valid_row, gid_sorted, -2)
    # Deduped node arrays in (l, d) order: rep = first i of its group.
    # Non-first rows go to the dropped slot n_pad.
    node_slot = torch.where(first, gid_sorted, n_pad)
    node_l = scatter_drop(-2, node_slot, s_l)
    node_d = scatter_drop(-2, node_slot, s_d)
    node_rep = scatter_drop(-2, node_slot, s_i)
    node_valid = idx < m
    node_r = torch.where(node_valid, take(nsv, node_rep) - 1, -2)

    # Parent rule: d' = max(lcp[l], lcp[r+1]); parent = interval of the
    # boundary position attaining it (root when d' == 0).
    pl = torch.where(node_valid, take(lcp_pad, node_l), 0)
    pr = torch.where(node_valid & (node_r + 1 <= n - 1),
                     take(lcp_pad, node_r + 1), 0)
    dp = torch.maximum(pl, pr)
    p_pos = torch.where(pl >= pr, node_l, node_r + 1)
    node_parent = torch.where(
        node_valid & (dp >= 1), take(pos2node, p_pos),
        torch.where(node_valid, -1, full(-2)))

    # Fold-exact label offsets: occurrence = table[r] if the parent
    # boundary is on the right (a later rank re-split the in-edge),
    # else table[rep-1] (creation-time offsets).
    occ = torch.where(pr > pl, take(sa_pad, node_r),
                      take(sa_pad, node_rep - 1))
    node_start = torch.where(node_valid, occ + dp, 0)
    node_end = torch.where(node_valid, occ + node_d, 0)

    # Per-rank attachment: depth max(lcp[i], lcp[i+1]).
    lcp_next = torch.cat([lcp_pad[1:], full(-1, 1)])
    lcp_next = torch.where(idx + 1 <= n - 1, lcp_next, 0)
    lcp_cur = torch.where((idx >= 1) & (idx < n), lcp_pad, 0)
    rank_valid = idx < n
    d_leaf = torch.maximum(lcp_cur, lcp_next)
    p_leaf = torch.where(lcp_cur >= lcp_next, idx, idx + 1)
    leaf_parent = torch.where(
        rank_valid & (d_leaf >= 1), take(pos2node, p_leaf),
        torch.where(rank_valid, -1, full(-2)))
    suf_len = torch.where(rank_valid, n - sa_pad, 0)
    is_term = rank_valid & (suf_len == d_leaf)
    leaf_start = torch.where(rank_valid, sa_pad + d_leaf, 0)
    # Terminal suffix per node (at most one: equal-length suffixes in
    # one interval would be equal strings).
    term_ok = is_term & (leaf_parent >= 0)
    node_term = scatter_drop(-1, torch.where(term_ok, leaf_parent, n_pad),
                             torch.where(term_ok, sa_pad, -1))
    node_term = torch.where(node_valid, node_term, -2)

    return dict(m=m, node_l=node_l, node_d=node_d, node_r=node_r,
                node_rep=node_rep, node_parent=node_parent,
                node_start=node_start, node_end=node_end,
                node_term=node_term, leaf_parent=leaf_parent,
                leaf_start=leaf_start, is_term=is_term)


class ANode:
    """Lazy Node-compatible view over the tree arrays.

    Duck-types the pointer Node (tree/stree.py): parent, children (a
    real dict, materialized per node on demand and cached), suffixes,
    start/end, path_len, plus the 5 iterator families.
    """

    __slots__ = ("_t", "kind", "id", "_children")

    def __init__(self, tree: "ArraySuffixTree", kind: str, id: int):
        self._t = tree
        self.kind = kind  # "root" | "node" | "leaf"
        self.id = id
        self._children = None

    # -- identity ----------------------------------------------------------

    def __eq__(self, other):
        return (isinstance(other, ANode) and self._t is other._t
                and self.kind == other.kind and self.id == other.id)

    def __hash__(self):
        return hash((id(self._t), self.kind, self.id))

    # -- attributes mirrored from Node -------------------------------------

    @property
    def parent(self) -> Optional["ANode"]:
        t = self._t
        if self.kind == "root":
            return None
        pid = (int(t.node_parent[self.id]) if self.kind == "node"
               else int(t.leaf_parent[self.id]))
        return t._node(pid)

    @property
    def suffixes(self) -> list[int]:
        t = self._t
        if self.kind == "root":
            return [t.n]
        if self.kind == "node":
            term = int(t.node_term[self.id])
            return [term] if term >= 0 else []
        return [int(t.sa[self.id])]

    @property
    def start(self) -> int:
        t = self._t
        if self.kind == "root":
            return 0
        if self.kind == "node":
            return int(t.node_start[self.id])
        return int(t.leaf_start[self.id])

    @property
    def end(self) -> int:
        t = self._t
        if self.kind == "root":
            return 0
        if self.kind == "node":
            return int(t.node_end[self.id])
        return t.n

    @property
    def path_len(self) -> int:
        t = self._t
        if self.kind == "root":
            return 0
        if self.kind == "node":
            return int(t.node_d[self.id])
        return t.n - int(t.sa[self.id])

    @property
    def children(self) -> dict[int, "ANode"]:
        if self._children is None:
            self._children = self._t._children_of(self)
        return self._children

    # -- structure ---------------------------------------------------------

    def __len__(self) -> int:
        return self.end - self.start

    def is_root(self) -> bool:
        return self.kind == "root"

    def has_terminals(self) -> bool:
        return bool(self.suffixes)

    def depth(self) -> int:
        return sum(1 for _ in self.ancestors()) - 1

    # -- iterators ----------------------------------------------------------

    def child_nodes(self) -> Iterator["ANode"]:
        for k in sorted(self.children):
            yield self.children[k]

    def ancestors(self) -> Iterator["ANode"]:
        cur: Optional[ANode] = self
        while cur is not None:
            yield cur
            cur = cur.parent

    def preorder(self) -> Iterator["ANode"]:
        stack = [self]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(list(node.child_nodes())))

    def leaves(self) -> Iterator["ANode"]:
        for nd in self.preorder():
            if len(nd) > 0 and nd.has_terminals():
                yield nd

    def suffix_indices(self) -> Iterator[int]:
        for leaf in self.leaves():
            yield from leaf.suffixes


class ArraySuffixTree:
    """Suffix tree held as flat arrays, built on device (see module doc).

    Exposes the same surface as tree/stree.py's SuffixTree: ``root()``,
    ``label(node)``, ``key(node)``, ``text()``, ``text_bytes()``,
    ``repr``, so dot rendering and the iterator battery run unchanged.
    The arrays are host numpy, copied off the device once.
    """

    def __init__(self, raw: bytes, was_str: bool, sa: np.ndarray,
                 arrays: dict):
        self._raw = raw
        self._was_str = was_str
        self.n = len(raw)
        self.sa = sa
        m = int(arrays["m"])
        self.m = m
        for name in ("node_l", "node_d", "node_r", "node_parent",
                     "node_start", "node_end", "node_term"):
            setattr(self, name, np.asarray(arrays[name], np.int32)[:m])
        self.leaf_parent = np.asarray(arrays["leaf_parent"],
                                      np.int32)[: self.n]
        self.leaf_start = np.asarray(arrays["leaf_start"],
                                     np.int32)[: self.n]
        self.is_term = np.asarray(arrays["is_term"], bool)[: self.n]
        self._root = ANode(self, "root", -1)
        self._edges = None  # lazy: (sorted keys, child kind/id arrays)

    # -- construction -------------------------------------------------------

    @classmethod
    def new(cls, text, device=None) -> "ArraySuffixTree":
        """The tree of ``text``; its table is built with ``engine="auto"``
        and the arrays derived on ``device`` (``None`` = CUDA)."""
        return cls.from_suffix_table(
            SuffixTable.new(text, engine="auto", device=device))

    @classmethod
    def from_suffix_table(cls, st: SuffixTable) -> "ArraySuffixTree":
        """The tree of a built table, derived on the table's device."""
        raw = st.text_bytes()
        n = len(st)
        was_str = isinstance(st.text(), str)
        sa = st.table()
        if n == 0:
            return cls(raw, was_str, sa, dict(
                m=0, node_l=[], node_d=[], node_r=[], node_parent=[],
                node_start=[], node_end=[], node_term=[], node_rep=[],
                leaf_parent=[], leaf_start=[], is_term=[]))
        lcp = getattr(st, "_lcp_override", None)
        if lcp is None:
            lcp = st.lcp_lens()
        n_pad = bucket_size(n)
        sa_pad = np.zeros((n_pad,), np.int32)
        sa_pad[:n] = sa
        lcp_pad = np.full((n_pad,), -1, np.int32)
        lcp_pad[:n] = lcp
        arrays = tree_arrays(torch.from_numpy(sa_pad).to(st.device),
                             torch.from_numpy(lcp_pad).to(st.device), n)
        arrays = {k: v.cpu().numpy() if isinstance(v, torch.Tensor) else v
                  for k, v in arrays.items()}
        return cls(raw, was_str, sa, arrays)

    # -- SuffixTree surface --------------------------------------------------

    def text(self):
        return self._raw.decode("utf-8") if self._was_str else self._raw

    def text_bytes(self) -> bytes:
        return self._raw

    def root(self) -> ANode:
        return self._root

    def label(self, node: ANode) -> bytes:
        return self._raw[node.start : node.end]

    def key(self, node: ANode) -> int:
        return self.label(node)[0]

    def __repr__(self) -> str:
        lines = ["", "-----------------------------------------",
                 "SUFFIX TREE"]
        try:
            lines.append(f"text: {self.text()}")
        except UnicodeDecodeError:
            lines.append(f"text: {self._raw!r}")

        def walk(node: ANode, depth: int):
            if node.is_root():
                lines.append("ROOT")
            else:
                lines.append("  " * depth + repr(self.label(node)))
            for child in node.child_nodes():
                walk(child, depth + 1)

        walk(self._root, 0)
        lines.append("-----------------------------------------")
        return "\n".join(lines) + "\n"

    # -- edge index ----------------------------------------------------------

    def _ensure_edges(self):
        if self._edges is not None:
            return self._edges
        text = np.frombuffer(self._raw, np.uint8)
        # Internal-node edges: parent (-1 = root) -> node.
        pn = self.node_parent
        leaf_mask = (~self.is_term.astype(bool))
        lp = self.leaf_parent[leaf_mask]
        leaf_ids = np.flatnonzero(leaf_mask).astype(np.int32)
        e_parent = np.concatenate([pn, lp]).astype(np.int64)
        e_byte = np.concatenate([
            text[np.minimum(self.node_start, max(self.n - 1, 0))],
            text[np.minimum(self.leaf_start[leaf_mask],
                            max(self.n - 1, 0))],
        ]).astype(np.int64)
        e_kind = np.concatenate([
            np.zeros(self.m, np.int8), np.ones(leaf_ids.size, np.int8)])
        e_child = np.concatenate([
            np.arange(self.m, dtype=np.int32), leaf_ids])
        order = np.argsort(e_parent * 256 + e_byte, kind="stable")
        self._edges = (e_parent[order], e_byte[order], e_kind[order],
                       e_child[order])
        return self._edges

    def _children_of(self, node: ANode) -> dict[int, ANode]:
        e_parent, e_byte, e_kind, e_child = self._ensure_edges()
        pid = -1 if node.kind == "root" else node.id
        if node.kind == "leaf":
            return {}
        lo = np.searchsorted(e_parent, pid, side="left")
        hi = np.searchsorted(e_parent, pid, side="right")
        out: dict[int, ANode] = {}
        for j in range(lo, hi):
            kind = "leaf" if e_kind[j] else "node"
            out[int(e_byte[j])] = ANode(self, kind, int(e_child[j]))
        return out

    def _node(self, pid: int) -> ANode:
        return self._root if pid < 0 else ANode(self, "node", pid)
