"""The port's host suffix tree (``suffix_torch/tree/stree.py``) and dot
renderer (``tree/dot.py``) against the JAX package's
(``suffix_tpu/tree/stree.py``, ``tree/dot.py``): node by node the same
children keys, label offsets, terminals and path lengths, the same
``label``/``key``/``repr`` and the same GraphViz string, byte for byte,
on the directed texts of ``tests/test_tree.py`` and
``tests/test_atree.py`` and on hypothesis texts and bytes; plus the
reference's tree invariants (suffix_tree/src/lib.rs:507-567) on the port
alone. Tolerance: exact equality.
"""

import pathlib
import sys

import pytest
from hypothesis import given, settings, strategies as hst

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable, SuffixTree  # noqa: E402
from suffix_torch.tree import Node, to_dot  # noqa: E402

DIRECTED = [
    "banana", "apple", "mississippi", "tgtgtgtgcaccg",
    "", "a", "ab", "ba", "aa", "aaaa", "aaaab", "abab", "ababab",
    "\x00", "☃abc☃", "the quick brown fox was quick.",
    b"\xff\xfe\xff\x00\xfe", b"banana bandana",
]


@pytest.fixture(scope="module")
def jax_tree():
    """(suffix_tpu.SuffixTable, SuffixTree, to_dot)."""
    pytest.importorskip("jax")
    import suffix_tpu
    from suffix_tpu.tree.dot import to_dot as jax_to_dot

    return suffix_tpu.SuffixTable, suffix_tpu.SuffixTree, jax_to_dot


def assert_same_tree(p_st, j_st):
    stack = [(p_st.root(), j_st.root())]
    while stack:
        p, j = stack.pop()
        assert p.suffixes == j.suffixes
        assert (p.start, p.end, p.path_len) == (j.start, j.end, j.path_len)
        assert p_st.label(p) == j_st.label(j)
        if not p.is_root():
            assert p_st.key(p) == j_st.key(j)
        assert list(p.children) == list(j.children)  # insertion order too
        for k in p.children:
            stack.append((p.children[k], j.children[k]))


def _pair(jax_tree, text):
    JTable, JTree, jax_to_dot = jax_tree
    port = SuffixTree.from_suffix_table(SuffixTable.new(text, device="cpu"))
    ref = JTree.from_suffix_table(JTable.new(text))
    return port, ref, jax_to_dot


@pytest.mark.parametrize("text", DIRECTED)
def test_directed_trees_match_jax(jax_tree, text):
    port, ref, jax_to_dot = _pair(jax_tree, text)
    assert_same_tree(port, ref)
    assert repr(port) == repr(ref)
    assert to_dot(port) == jax_to_dot(ref)
    assert port.text() == ref.text()
    assert port.text_bytes() == ref.text_bytes()


@settings(max_examples=40, deadline=None)
@given(hst.text(max_size=48))
def test_qc_text_trees_match_jax(jax_tree, s):
    port, ref, jax_to_dot = _pair(jax_tree, s)
    assert_same_tree(port, ref)
    assert to_dot(port) == jax_to_dot(ref)


@settings(max_examples=40, deadline=None)
@given(hst.binary(max_size=64))
def test_qc_byte_trees_match_jax(jax_tree, s):
    port, ref, jax_to_dot = _pair(jax_tree, s)
    assert_same_tree(port, ref)
    assert repr(port) == repr(ref)
    assert to_dot(port) == jax_to_dot(ref)


@settings(max_examples=40, deadline=None)
@given(hst.text(max_size=40))
def test_qc_tree_invariants(s):
    # Leaf count == byte length (lib.rs:529-534); internal nodes without
    # terminals have >= 2 children; preorder suffix indices enumerate the
    # SA in order (lib.rs:551-566).
    sa = SuffixTable.new(s, device="cpu")
    tree = SuffixTree.from_suffix_table(sa)
    assert sum(1 for _ in tree.root().leaves()) == len(s.encode("utf-8"))
    for node in tree.root().preorder():
        if not node.has_terminals():
            assert len(node.children) >= 2
        if not node.is_root():
            assert node.path_len == node.parent.path_len + len(node)
            assert list(node.ancestors())[-1] is tree.root()
    assert list(tree.root().suffix_indices()) == sa.table().tolist()


def test_new_and_lcp_override_match_jax(jax_tree):
    JTable, JTree, jax_to_dot = jax_tree
    text = "mississippi river"
    port = SuffixTree.new(text, device="cpu")
    assert to_dot(port) == jax_to_dot(JTree.new(text))
    # The fold takes an LCP array computed elsewhere (_lcp_override).
    st = SuffixTable.new(text, device="cpu")
    st._lcp_override = st.lcp_lens("kasai")
    assert to_dot(SuffixTree.from_suffix_table(st)) == to_dot(port)
    assert isinstance(port.root(), Node) and port.root().depth() == 0


def _from_sharded_rank(mesh, text: bytes):
    """One rank of an 8-rank gloo world: the tree of a sharded index
    (collective; every rank folds the same tree)."""
    from suffix_torch.parallel.dist_query import ShardedQueryIndex

    tree = SuffixTree.from_sharded(ShardedQueryIndex(text, mesh))
    return ([n.suffixes for n in tree.root().preorder()],
            list(tree.root().suffix_indices()), to_dot(tree))


def test_from_sharded_raises(jax_tree):
    """``SuffixTree.from_sharded`` over 8 gloo ranks (the test's name
    dates from when it raised): the same preorder ``suffixes``,
    ``suffix_indices`` and dot as JAX's over 8 virtual devices and as the
    port's own fold of the table (tests/test_tree.py)."""
    from suffix_torch.parallel import launch
    from suffix_tpu.parallel.dist_query import ShardedQueryIndex
    from suffix_tpu.parallel.mesh import make_mesh

    JTable, JTree, jax_to_dot = jax_tree
    text = b"banana bandana"
    suffixes, indices, dot = launch.spawn(_from_sharded_rank, 8, text,
                                          device="cpu")
    want = JTree.from_sharded(ShardedQueryIndex(text, make_mesh(8)))
    assert suffixes == [n.suffixes for n in want.root().preorder()]
    assert indices == list(want.root().suffix_indices())
    assert dot == jax_to_dot(want)
    ref = SuffixTree.new(text, device="cpu")
    assert suffixes == [n.suffixes for n in ref.root().preorder()]
    assert dot == to_dot(ref)


def test_new_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        SuffixTree.new("banana")


def test_dot_of_banana_is_pinned(jax_tree):
    # chip_smoke.py holds the CLI's `stree banana` on the card to this
    # constant: JAX's string, pinned.
    root = str(pathlib.Path(__file__).resolve().parent.parent)
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)

    _, JTree, jax_to_dot = jax_tree
    assert jax_to_dot(JTree.new("banana")) == chip_smoke.BANANA_DOT
    assert to_dot(SuffixTree.new("banana", device="cpu")) == \
        chip_smoke.BANANA_DOT
