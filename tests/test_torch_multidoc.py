"""The port's ``MultiDocIndex`` (``suffix_torch/multidoc.py``) against the
JAX package's (``suffix_tpu/multidoc.py``), the cases of
``tests/test_multidoc.py`` (reference: README.md:60-74): the same
(doc, offset) pairs in the same order, the same document lookups, the
same NUL rejections; ``mesh=`` builds over 8 gloo ranks started for the
test (``parallel/launch.py``), against JAX's ``make_mesh(8)`` index.
Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import MultiDocIndex  # noqa: E402
from suffix_torch.parallel import launch  # noqa: E402

MESH_DOCS = ["the quick fox", "a lazy dog", "quick quick"]
MESH_QUERIES = ["quick", "dog", "zebra", "q"]

CORPORA = [
    (["the quick fox", "a lazy dog", "quick quick"],
     ["quick", "lazy", "zebra", "q", "dog", " ", "k q", "fox"]),
    (["xxab", "cdyy"], ["abcd", "ab", "cd", "b", "yy"]),
    ([b"\xff\xfe", b"\xfe\xff"], [b"\xfe", b"\xff", b"\xfe\xff"]),
    (["", "a", ""], ["a", "b"]),
    (["abc", "de", "f"], ["c", "de", "f", "cd"]),
    (["banana", "bandana", "cabana"], ["ana", "ban", "a", "nana", "cab"]),
]


@pytest.fixture(scope="module")
def JIndex():
    pytest.importorskip("jax")
    from suffix_tpu import MultiDocIndex as J

    return J


@pytest.mark.parametrize("docs,queries", CORPORA)
def test_positions_match_jax(JIndex, docs, queries):
    port = MultiDocIndex(docs, device="cpu")
    ref = JIndex(docs)
    assert port.num_docs == ref.num_docs
    assert port.positions_batch(queries) == ref.positions_batch(queries)
    for q in queries:
        assert port.positions(q) == ref.positions(q)
        assert port.contains(q) == ref.contains(q)
        assert port.docs_containing(q) == ref.docs_containing(q)
    for i in range(len(docs)):
        assert port.doc(i) == ref.doc(i)
    assert np.array_equal(port.suffix_table.table(), ref.suffix_table.table())


def test_basic():
    idx = MultiDocIndex(["the quick fox", "a lazy dog", "quick quick"],
                        device="cpu")
    assert sorted(idx.positions("quick")) == [(0, 4), (2, 0), (2, 6)]
    assert idx.docs_containing("quick") == [0, 2]
    assert idx.contains("lazy") and not idx.contains("zebra")
    # No match across the separator.
    assert MultiDocIndex(["xxab", "cdyy"], device="cpu").positions("abcd") == []


def test_locate_matches_jax(JIndex):
    port = MultiDocIndex(["abc", "de", "f"], device="cpu")
    ref = JIndex(["abc", "de", "f"])
    # joined: abc\0de\0f -> starts [0, 4, 7]
    for pos in range(9):
        assert port.locate(pos) == ref.locate(pos)
    assert port.locate(4) == (1, 0)


def test_rejects_nul_like_jax(JIndex):
    for cls, kw in ((MultiDocIndex, {"device": "cpu"}), (JIndex, {})):
        with pytest.raises(ValueError, match="NUL separator"):
            cls(["a\x00b"], **kw)
        with pytest.raises(ValueError, match="NUL separator"):
            cls(["ab"], **kw).positions("a\x00")


def test_unbuilt_index():
    idx = MultiDocIndex(["ab", "cd"], build=False, device="cpu")
    assert idx.suffix_table is None and idx.num_docs == 2


def _mesh_index(mesh):
    idx = MultiDocIndex(MESH_DOCS, mesh=mesh, device="cpu")
    return ([idx.positions(q) for q in MESH_QUERIES],
            idx.suffix_table.table(), str(idx.suffix_table.device))


def test_mesh_raises(JIndex):
    # Once a stub that raised; now test_multidoc.py's sharded-mesh case.
    from suffix_tpu.parallel.mesh import make_mesh

    positions, table, device = launch.spawn(_mesh_index, 8, device="cpu")
    ref = JIndex(MESH_DOCS, mesh=make_mesh(8))
    assert positions == [ref.positions(q) for q in MESH_QUERIES]
    assert np.array_equal(table, ref.suffix_table.table())
    assert positions == [MultiDocIndex(MESH_DOCS, device="cpu").positions(q)
                         for q in MESH_QUERIES]
    assert device == "cpu"
