"""The port's probe-chain query engines against the JAX package's:
``bounds_batch`` (``suffix_torch/ops/search.py``), ``probe_lut`` and
``bounds_batch_fast`` (``suffix_torch/ops/search2.py``) beside
``suffix_tpu.ops.search.bounds_batch`` and ``suffix_tpu.ops.search2``'s
``build_query_index`` (its fourth value, the LUT) and
``bounds_batch_fast``, on the texts and queries of ``tests/test_search.py``
and the ``bounds_batch_fast`` cases of ``tests/test_search2.py``; each
engine also against the port's merge-join ``bounds_batch_merge`` and the
bytes. Tolerance: exact equality (starts of empty ranges included, for
the JAX pairs).
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch.ops import search, search2  # noqa: E402
from suffix_torch.ops.padding import PAD, bucket_size  # noqa: E402
from suffix_torch.ops.prefix_doubling import suffix_array_bytes  # noqa: E402


@pytest.fixture(scope="module")
def jax_ops():
    """(suffix_tpu.ops.search, suffix_tpu.ops.search2, jax.numpy)."""
    pytest.importorskip("jax")
    import jax.numpy as jnp
    from suffix_tpu.ops import search as s1, search2 as s2

    return s1, s2, jnp


def _pack(queries):
    """(Q, m) int32 and lengths, Q and m padded to powers of two (at least
    8 and 16) with empty queries, so the JAX programs compile once per
    shape bucket."""
    q, qlens = search.pack_queries(queries)
    rows = bucket_size(len(queries), minimum=8)
    out = np.full((rows, bucket_size(q.shape[1])), PAD, np.int32)
    out[:q.shape[0], :q.shape[1]] = q
    lens = np.zeros(rows, np.int32)
    lens[:len(queries)] = qlens
    return out, lens


def engines(jax_ops, text: bytes, queries):
    """Every engine's (start, count) on one padded text and batch; the
    JAX pairs and the LUT are checked here, exactly."""
    s1, s2, jnp = jax_ops
    n = len(text)
    n_pad = bucket_size(max(n, 1))
    t = np.full(n_pad, PAD, np.int32)
    t[:n] = np.frombuffer(text, np.uint8)
    tab = np.zeros(n_pad, np.int32)
    tab[:n] = suffix_array_bytes(text, device="cpu")
    q, qlens = _pack(queries)
    n_iters = max(1, (n_pad + 1).bit_length())
    m = q.shape[1]

    jt, jtab, jq, jl = (jnp.asarray(a) for a in (t, tab, q, qlens))
    jn = jnp.int32(n)
    j1 = s1.bounds_batch(jt, jn, jtab, jn, jq, jl, n_iters)
    jpk, _, _, jlut = s2.build_query_index(jt, jtab, jn)
    j2 = s2.bounds_batch_fast(jt, jn, jtab, jn, jpk[0], jpk[1], jlut, jq, jl,
                              n_iters, m)

    pt, ptab, pq, pl = (torch.from_numpy(a) for a in (t, tab, q, qlens))
    p1 = search.bounds_batch(pt, n, ptab, n, pq, pl, n_iters)
    pk, fence, block = search2.build_query_index(pt, ptab, n)
    lut = search2.probe_lut(pk[0], n)
    p2 = search2.bounds_batch_fast(pt, n, ptab, n, pk[0], pk[1], lut, pq, pl,
                                   n_iters, m)
    p3 = search2.bounds_batch_merge(pt, n, ptab, n, fence, block, pq, pl, m)

    assert lut.dtype == torch.int32
    assert np.array_equal(lut.numpy(), np.asarray(jlut))
    for port, ref in ((p1, j1), (p2, j2)):
        for got, want in zip(port, ref):
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), np.asarray(want)), (
                text[:32], queries)
    return tuple(tuple(x.numpy()[:len(queries)] for x in r)
                 for r in (p1, p2, p3))


def occurrences(text: bytes, q: bytes) -> list[int]:
    out, i = [], text.find(q) if q else -1
    while i != -1:
        out.append(i)
        i = text.find(q, i + 1)
    return out


def assert_engines_agree(jax_ops, text, queries):
    """Probe engines equal JAX's; all three equal each other and the
    bytes (start only where the count is not 0)."""
    text = text.encode() if isinstance(text, str) else text
    queries = [q.encode() if isinstance(q, str) else q for q in queries]
    (s1, c1), (s2, c2), (s3, c3) = engines(jax_ops, text, queries)
    assert np.array_equal(c1, c2) and np.array_equal(c1, c3)
    live = c1 > 0
    assert np.array_equal(s1[live], s2[live])
    assert np.array_equal(s1[live], s3[live])
    table = suffix_array_bytes(text, device="cpu")
    for q, s, c in zip(queries, s1, c1):
        assert sorted(table[s:s + c].tolist()) == occurrences(text, q), q


# tests/test_search.py: each directed text with the queries it asks.
SEARCH_CASES = [
    ("", ["", "a", "ab"]),
    ("a", ["", "b", "a"]),
    ("ab", ["b", "a", "ab", "abc"]),
    ("aa", ["a", "aa", "aaa", "mnomnomnomnomnomnomno"]),
    ("zzzzzaazzzzz", ["a", "aa", "za", "zzzzz"]),
    ("zzzzabczzzzzabczzzzzz", ["abc", "zabcz", "czzzzzab"]),
    ("az", ["mnomnomnomnomnomnomno"]),
    ("zz", ["mnomnomnomnomnomnomno"]),
    ("The quick brown fox was very quick.", ["quick", "zebra", ""]),
    ("☃abc☃", ["☃", "abc☃", "☃a", "c"]),
    ("the quick brown fox was quick.",
     ["quick", "faux", "fox", "zebra", "", "the", "."]),
    ("banana", ["an", "a", "x", "nana", "banana", "bananas"]),
]

# tests/test_search2.py: the bounds_batch_fast cases.
FAST_CASES = [
    (b"the quick brown fox was quick.",
     ["quick", "q", "", "the quick brown fox was quick.", "zebra", ".", " ",
      "quick.", "quick.x", "th", "qu", "quicksand"]),
    (b"abcdefabcdefabcdefxyz",
     ["abcde", "abcdef", "abcdefa", "abcdefx", "bcdefa",
      "abcdefabcdefabcdefxyz", "abcdefabcdefabcdefxyzQ"]),
    (b"a" * 500, ["a", "aa", "aaaaaa", "aaaaaaa", "a" * 100, "a" * 500,
                  "a" * 501, "b"]),
    (b"\x00\x00a\x00b", [b"\x00", b"\x00a", b"\x00\x00", b"a\x00b", b"b\x00"]),
    (bytes(range(250, 256)) * 9,
     [bytes([255]), bytes([250, 251]), bytes(range(250, 256)) * 2]),
]

# tests/test_search2.py::test_merge_engine_agrees.
MERGE_TEXTS = [b"the quick brown fox was quick.", b"a" * 300, b"\x00ab\x00",
               bytes(range(256)) * 3, b"banana" * 20]
MERGE_QUERIES = ["quick", "", "a", "an", "banana", "nanana", "\x00",
                 "the quick brown fox was quick.", "xyzzy", "aaaaaaa"]


@pytest.mark.parametrize("text,queries", SEARCH_CASES,
                         ids=lambda v: repr(v)[:16])
def test_search_cases_match_jax(jax_ops, text, queries):
    assert_engines_agree(jax_ops, text, queries)


@pytest.mark.parametrize("text,queries", FAST_CASES,
                         ids=lambda v: repr(v)[:16])
def test_fast_cases_match_jax(jax_ops, text, queries):
    assert_engines_agree(jax_ops, text, queries)


@pytest.mark.parametrize("text", MERGE_TEXTS, ids=lambda v: repr(v)[:16])
def test_merge_texts_match_jax(jax_ops, text):
    assert_engines_agree(jax_ops, text, MERGE_QUERIES)


def test_dna_probes_match_jax(jax_ops, dna_10k):
    # test_search.py::test_dna_queries and test_search2.py's end-to-end
    # probes: 14-, 7- and 31-byte patterns (the long ones refine).
    probes = [dna_10k[i:i + 14] for i in range(0, 2000, 97)] + [b"NOPE!"]
    probes += [dna_10k[i:i + 7] for i in range(0, 3000, 151)]
    probes += [dna_10k[i:i + 31] for i in range(0, 3000, 307)] + [b"NOPE"]
    assert_engines_agree(jax_ops, dna_10k, probes)


def test_probe_lut_buckets(jax_ops):
    """The LUT's entry for a two-symbol value is its first rank, and the
    entries past the real rows point at n_table, on a padded table."""
    text = b"mississippi river"
    n = len(text)
    n_pad = bucket_size(n)
    t = np.full(n_pad, PAD, np.int32)
    t[:n] = np.frombuffer(text, np.uint8)
    tab = np.zeros(n_pad, np.int32)
    sa = suffix_array_bytes(text, device="cpu")
    tab[:n] = sa
    pk, _, _ = search2.build_query_index(torch.from_numpy(t),
                                         torch.from_numpy(tab), n)
    lut = search2.probe_lut(pk[0], n).numpy()
    side = search2.LUT_SIDE
    assert lut.shape == (side * side + 1,) and lut[-1] == n
    for r, p in enumerate(sa):
        s0 = text[p] + 1
        s1 = text[p + 1] + 1 if p + 1 < n else 0
        assert lut[s0 * side + s1] <= r
    assert lut[(ord("s") + 1) * side + ord("s") + 1] == \
        sorted(text[p:] for p in range(n)).index(b"ssippi river")


@settings(max_examples=40, deadline=None)
@given(st.binary(min_size=0, max_size=80),
       st.lists(st.binary(min_size=0, max_size=12), min_size=1, max_size=6))
def test_prop_engines_agree(jax_ops, text, queries):
    assert_engines_agree(jax_ops, text, queries)


@settings(max_examples=30, deadline=None)
@given(st.text(alphabet="ab", max_size=60),
       st.lists(st.text(alphabet="ab", max_size=9), min_size=1, max_size=4))
def test_prop_dense(jax_ops, text, queries):
    assert_engines_agree(jax_ops, text, queries)
