"""The port's array suffix tree (``suffix_torch/tree/atree.py``) against
the JAX package's (``suffix_tpu/tree/atree.py``): every array
(``node_l/d/r/parent/start/end/term``, ``leaf_parent``, ``leaf_start``,
``is_term``) and the node count ``m`` exactly equal, element for element
and dtype for dtype, on the directed texts, small-sigma random texts, the
empty and one-byte texts and the 100 KB fixture; the reference's tree
invariants on the 100 KB arrays; and the dot string equal to the host
fold's. JAX is imported by a fixture, so the CUDA leg (marker ``gpu``:
``tree_arrays`` on the card equal to the CPU) runs without it:
``python -m pytest tests/test_torch_atree.py -m gpu --noconftest``.
Tolerance: exact equality.
"""

import pathlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as hst

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import ArraySuffixTree, SuffixTable, SuffixTree  # noqa: E402
from suffix_torch.ops.padding import bucket_size  # noqa: E402
from suffix_torch.tree.atree import tree_arrays  # noqa: E402
from suffix_torch.tree.dot import to_dot  # noqa: E402

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures"
DIRECTED = [
    "banana", "apple", "mississippi", "tgtgtgtgcaccg",
    "", "a", "ab", "ba", "aa", "aaaa", "aaaab", "abab", "ababab",
    "\x00", "☃abc☃", "the quick brown fox was quick.", "x",
]
ARRAYS = ("node_l", "node_d", "node_r", "node_parent", "node_start",
          "node_end", "node_term", "leaf_parent", "leaf_start", "is_term")


@pytest.fixture(scope="module")
def JTree():
    """(suffix_tpu.SuffixTable, suffix_tpu ArraySuffixTree)."""
    pytest.importorskip("jax")
    import suffix_tpu
    from suffix_tpu.tree.atree import ArraySuffixTree as JArray

    return suffix_tpu.SuffixTable, JArray


def assert_arrays_equal(port, ref):
    assert port.m == ref.m
    assert port.n == ref.n
    assert np.array_equal(port.sa, ref.sa)
    for name in ARRAYS:
        got, want = getattr(port, name), getattr(ref, name)
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name


def assert_tree_equal(a_st, f_st):
    stack = [(a_st.root(), f_st.root())]
    while stack:
        a, f = stack.pop()
        assert sorted(a.suffixes) == sorted(f.suffixes)
        assert a_st.label(a) == f_st.label(f)
        assert (a.start, a.end, a.path_len) == (f.start, f.end, f.path_len)
        assert sorted(a.children) == sorted(f.children)
        for k in a.children:
            stack.append((a.children[k], f.children[k]))


def _both(JTree, text, engine="device"):
    JTable, JArray = JTree
    tab = SuffixTable.new(text, engine=engine, device="cpu")
    port = ArraySuffixTree.from_suffix_table(tab)
    ref = JArray.from_suffix_table(JTable.new(text, engine=engine))
    return tab, port, ref


@pytest.mark.parametrize("text", DIRECTED)
def test_directed_arrays_match_jax(JTree, text):
    tab, port, ref = _both(JTree, text)
    assert_arrays_equal(port, ref)
    fold = SuffixTree.from_suffix_table(tab)
    assert_tree_equal(port, fold)
    assert to_dot(port) == to_dot(fold)
    assert repr(port) == repr(ref)


@settings(max_examples=25, deadline=None)
@given(hst.integers(1, 200), hst.integers(2, 3), hst.integers(0, 999))
def test_qc_small_sigma_arrays_match_jax(JTree, n, sigma, seed):
    # Small alphabets maximize deep, nested lcp intervals.
    rng = np.random.default_rng(seed)
    raw = rng.integers(97, 97 + sigma, size=n, dtype=np.uint8).tobytes()
    _, port, ref = _both(JTree, raw)
    assert_arrays_equal(port, ref)


@settings(max_examples=25, deadline=None)
@given(hst.binary(max_size=64))
def test_qc_bytes_tree_equals_fold(b):
    tab = SuffixTable.new(b, device="cpu")
    assert_tree_equal(ArraySuffixTree.from_suffix_table(tab),
                      SuffixTree.from_suffix_table(tab))


def check_invariants(tree, sa: np.ndarray, spot: int = 2000) -> None:
    """The reference's three tree invariants (lib.rs:507-567) on the
    arrays, as tests/test_atree.py states them."""
    n = tree.n
    n_term = int(tree.is_term.sum())
    assert n_term == int((tree.node_term >= 0).sum())
    # leaves() = every true leaf + terminal-carrying internals with a
    # non-empty label: exactly the byte length.
    leaf_like = (n - n_term) + int(
        ((tree.node_term >= 0) & (tree.node_end > tree.node_start)).sum())
    assert leaf_like == n
    e_parent = tree._ensure_edges()[0]
    counts = np.bincount(e_parent[e_parent >= 0].astype(np.int64),
                         minlength=tree.m)
    has_term = tree.node_term >= 0
    assert np.all((counts >= 2) | (has_term & (counts >= 1)))
    for i, sufi in enumerate(tree.root().suffix_indices()):
        assert sufi == int(sa[i])
        if i >= spot:
            break
    pd = np.where(tree.node_parent >= 0,
                  tree.node_d[np.maximum(tree.node_parent, 0)], 0)
    assert np.all(tree.node_d > pd)


def test_fixture_100kb_matches_jax_and_invariants(JTree, dna_100k):
    tab, port, ref = _both(JTree, dna_100k, engine="auto")
    assert_arrays_equal(port, ref)
    check_invariants(port, tab.table())


def test_new_entrypoint_and_empty():
    tree = ArraySuffixTree.new("banana", device="cpu")
    assert to_dot(tree) == to_dot(SuffixTree.new("banana", device="cpu"))
    empty = ArraySuffixTree.new("", device="cpu")
    assert empty.m == 0 and empty.root().suffixes == [0]
    assert to_dot(empty) == to_dot(SuffixTree.new("", device="cpu"))


def test_tree_arrays_sentinels():
    # Past m every node array holds -2; past n every rank array -2 / 0.
    tab = SuffixTable.new("abracadabra", device="cpu")
    n = len(tab)
    n_pad = bucket_size(n)
    sa = np.zeros(n_pad, np.int32)
    sa[:n] = tab.table()
    lcp = np.full(n_pad, -1, np.int32)
    lcp[:n] = tab.lcp_lens()
    out = tree_arrays(torch.from_numpy(sa), torch.from_numpy(lcp), n)
    m = out["m"]
    assert 0 < m < n
    for name in ("node_l", "node_d", "node_r", "node_parent", "node_term"):
        assert out[name].dtype == torch.int32
        assert bool((out[name][m:] == -2).all()), name
    assert bool((out["leaf_parent"][n:] == -2).all())
    assert not bool(out["is_term"][n:].any())


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.gpu
def test_cuda_tree_arrays_equal_cpu(cuda_device):
    dna_100k = (FIXTURES / "AP009048_100000.fasta").read_bytes()
    tab_cpu = SuffixTable.new(dna_100k, engine="auto", device="cpu")
    tab_gpu = SuffixTable.new(dna_100k, engine="auto", device=cuda_device)
    got = ArraySuffixTree.from_suffix_table(tab_gpu)
    want = ArraySuffixTree.from_suffix_table(tab_cpu)
    assert_arrays_equal(got, want)
    check_invariants(got, tab_gpu.table())
