"""Suffix tree derived from SA + LCP in one linear pass, ported from
``suffix_tpu/tree/stree.py``.

Equivalent of the reference's separate ``suffix_tree`` crate
(suffix_tree/src/lib.rs:392-505): instead of Ukkonen's online algorithm,
the tree is folded from the already-sorted suffix table and its LCP array
left to right. For each rank, climb from the last-inserted node to the
deepest ancestor whose path length is <= lcp; if equal, attach a leaf; if
less, split the rightmost edge with a new internal node. The SA and LCP
come from the table (built on its device); the pointer-chasing fold is
host code by design.
"""

from __future__ import annotations

from typing import Iterator, Optional

from suffix_torch.table import SuffixTable, _as_bytes


class Node:
    """A suffix-tree node (cf. suffix_tree/src/lib.rs:52-59)."""

    __slots__ = ("parent", "children", "suffixes", "start", "end", "path_len")

    def __init__(self, start: int, end: int, suffixes=None):
        self.parent: Optional["Node"] = None
        self.children: dict[int, "Node"] = {}  # keyed by first label byte
        self.suffixes: list[int] = list(suffixes or [])
        self.start = start
        self.end = end
        self.path_len = 0

    # -- structure ---------------------------------------------------------

    def add_parent(self, node: "Node") -> None:
        self.parent = node
        self.path_len = node.path_len + len(self)

    def __len__(self) -> int:
        """Length of the path label *into* this node."""
        return self.end - self.start

    def is_root(self) -> bool:
        return self.parent is None

    def has_terminals(self) -> bool:
        return bool(self.suffixes)

    def depth(self) -> int:
        return sum(1 for _ in self.ancestors()) - 1

    # -- iterators (cf. suffix_tree/src/lib.rs:275-390) ---------------------

    def child_nodes(self) -> Iterator["Node"]:
        """Children in key (first label byte) order."""
        for k in sorted(self.children):
            yield self.children[k]

    def ancestors(self) -> Iterator["Node"]:
        cur: Optional[Node] = self
        while cur is not None:
            yield cur
            cur = cur.parent

    def preorder(self) -> Iterator["Node"]:
        stack = [self]
        while stack:
            node = stack.pop()
            yield node
            stack.extend(reversed(list(node.child_nodes())))

    def leaves(self) -> Iterator["Node"]:
        """Nodes with terminals and a non-empty label (may have children)."""
        for n in self.preorder():
            if len(n) > 0 and n.has_terminals():
                yield n

    def suffix_indices(self) -> Iterator[int]:
        for leaf in self.leaves():
            yield from leaf.suffixes


class SuffixTree:
    """A suffix tree over a text (cf. suffix_tree/src/lib.rs:46-49)."""

    def __init__(self, text, root: Node, *, _was_str: bool | None = None):
        raw, was_str = _as_bytes(text)
        self._raw = raw
        self._was_str = was_str if _was_str is None else _was_str
        self._root = root

    @classmethod
    def new(cls, text, device=None) -> "SuffixTree":
        """The tree of ``text``; its suffix table is built on ``device``
        (``None`` = CUDA)."""
        return cls.from_suffix_table(SuffixTable.new(text, device=device))

    @classmethod
    def from_suffix_table(cls, sa: SuffixTable) -> "SuffixTree":
        return _to_suffix_tree(sa)

    @classmethod
    def from_sharded(cls, idx) -> "SuffixTree":
        """Tree from a mesh-sharded index (``parallel/dist_query.py``).

        The SA and the LCP array come from the collective engines; only
        the linear host fold (suffix_tree/src/lib.rs:392-505) runs here.
        Collective: every rank of ``idx.mesh`` calls it."""
        st = SuffixTable.from_parts(idx._text_bytes(), idx.table(),
                                    device=idx.mesh.device)
        st._lcp_override = idx.lcp_lens()
        return _to_suffix_tree(st)

    def text(self):
        return self._raw.decode("utf-8") if self._was_str else self._raw

    def text_bytes(self) -> bytes:
        return self._raw

    def root(self) -> Node:
        return self._root

    def label(self, node: Node) -> bytes:
        """The path label *into* ``node``."""
        return self._raw[node.start : node.end]

    def key(self, node: Node) -> int:
        return self.label(node)[0]

    def __repr__(self) -> str:
        lines = ["", "-----------------------------------------", "SUFFIX TREE"]
        try:
            lines.append(f"text: {self.text()}")
        except UnicodeDecodeError:
            lines.append(f"text: {self._raw!r}")

        def walk(node: Node, depth: int):
            if node.is_root():
                lines.append("ROOT")
            else:
                lines.append("  " * depth + repr(self.label(node)))
            for child in node.child_nodes():
                walk(child, depth + 1)

        walk(self._root, 0)
        lines.append("-----------------------------------------")
        return "\n".join(lines) + "\n"


def _to_suffix_tree(sa: SuffixTable) -> SuffixTree:
    """SA+LCP -> tree fold (cf. suffix_tree/src/lib.rs:392-505).

    A table carrying ``_lcp_override`` (an LCP array computed elsewhere)
    folds that array instead of calling ``lcp_lens()``."""
    raw = sa.text_bytes()
    n = len(sa)
    table = sa.table()
    lcp_lens = getattr(sa, "_lcp_override", None)
    if lcp_lens is None:
        lcp_lens = sa.lcp_lens()
    root = Node(0, 0, suffixes=[n])
    st = SuffixTree(raw, root, _was_str=isinstance(sa.text(), str))
    last = root
    for i in range(n):
        sufstart = int(table[i])
        lcp_len = int(lcp_lens[i])
        # Climb to the deepest ancestor with path_len <= lcp_len.
        vins = last
        while vins.path_len > lcp_len and vins.parent is not None:
            vins = vins.parent
        dv = vins.path_len
        if dv == lcp_len:
            # The suffix extends vins exactly: new leaf.
            leaf = Node(sufstart + lcp_len, n, suffixes=[sufstart])
            leaf.add_parent(vins)
            first_char = st.key(leaf)
            if first_char in vins.children:
                raise AssertionError("two leaves share a first byte")
            vins.children[first_char] = leaf
            last = leaf
        elif dv < lcp_len:
            # Split the rightmost edge of vins at depth lcp_len.
            rkey = max(vins.children)
            rnode = vins.children.pop(rkey)
            prev_suf = int(table[i - 1])
            internal = Node(prev_suf + dv, prev_suf + lcp_len)
            internal.add_parent(vins)
            rnode.start = prev_suf + lcp_len
            rnode.end = prev_suf + rnode.path_len
            rnode.add_parent(internal)
            leaf = Node(sufstart + lcp_len, n, suffixes=[sufstart])
            leaf.add_parent(internal)
            last = leaf
            if st.key(rnode) == st.key(leaf):
                raise AssertionError("split children share a first byte")
            internal.children[st.key(rnode)] = rnode
            internal.children[st.key(leaf)] = leaf
            vins.children[st.key(internal)] = internal
        else:  # pragma: no cover - impossible by LCP definition
            raise AssertionError("ancestor deeper than LCP")
    return st
