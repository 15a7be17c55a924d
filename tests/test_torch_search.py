"""Port merge-join query engine against ``suffix_tpu.ops.search2``.

The same padded text, suffix table and query batch go through both
packages' ``build_query_index`` + ``bounds_batch_merge``; starts and
counts must be identical. Stride 1 (n_pad <= 4096) and stride 16
(``dna_10k``), 6-word keys (byte refine past 18 bytes) and 12-word keys.
Tolerance: exact equality.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from suffix_tpu.ops import search as jax_search  # noqa: E402
from suffix_tpu.ops import search2 as jax_search2  # noqa: E402
from suffix_torch.ops import search2  # noqa: E402
from suffix_torch.ops.naive import naive_table  # noqa: E402
from suffix_torch.ops.padding import PAD, bucket_size  # noqa: E402
from suffix_torch.ops.sais import suffix_array_sais_recursive  # noqa: E402
from suffix_torch.ops.search import pack_queries  # noqa: E402

QLENS = [0, 1, 3, 14, 18, 19, 36, 37, 60]


def _queries(text: bytes, rng: np.random.Generator) -> list[bytes]:
    n = len(text)
    qs = []
    for m in QLENS:
        for s in rng.integers(0, max(n - m, 1), size=4):
            qs.append(text[s:s + m])          # present
        qs.append(text[n - m:] if m else b"")  # ends at the text end
        qs.append(text[n - m // 2:] + b"zz")   # runs past the text end
        qs.append(bytes(rng.integers(0, 256, size=m, dtype=np.uint8)))
    qs += ["☃".encode(), "☃abc".encode(), b"\xe2", b"\xe2\x98"]
    return qs


def _both(text: bytes, queries: list[bytes], key_words: int):
    n = len(text)
    n_pad = bucket_size(max(n, 1))
    t = np.full(n_pad, PAD, np.int32)
    t[:n] = np.frombuffer(text, np.uint8)
    tab = np.zeros(n_pad, np.int32)
    tab[:n] = suffix_array_sais_recursive(text, device="cpu")
    q, qlens = pack_queries(queries)
    m_pad = bucket_size(q.shape[1], minimum=8)
    full_q = np.full((bucket_size(len(queries), minimum=8), m_pad), PAD,
                     np.int32)
    full_q[: len(queries), : q.shape[1]] = q
    full_lens = np.zeros(full_q.shape[0], np.int32)
    full_lens[: len(queries)] = qlens

    _, fence, block = search2.build_query_index(
        torch.from_numpy(t), torch.from_numpy(tab), n, key_words=key_words)
    got = search2.bounds_batch_merge(
        torch.from_numpy(t), n, torch.from_numpy(tab), n, fence, block,
        torch.from_numpy(full_q), torch.from_numpy(full_lens), m_pad)

    jt, jtab = jnp.asarray(t), jnp.asarray(tab)
    _, jfence, jblock, _ = jax_search2.build_query_index(
        jt, jtab, jnp.int32(n), key_words=key_words)
    want = jax_search2.bounds_batch_merge(
        jt, jnp.int32(n), jtab, jnp.int32(n), jfence, jblock,
        jnp.asarray(full_q), jnp.asarray(full_lens),
        max(1, (n_pad + 1).bit_length()), m_pad)
    return ([g.numpy() for g in got], [np.asarray(w) for w in want],
            block is None)


@pytest.mark.parametrize("key_words", [search2.KEY_WORDS,
                                       search2.EXT_KEY_WORDS])
@pytest.mark.parametrize("corpus", ["small", "dna_10k"])
def test_bounds_match_jax(corpus, key_words, dna_10k):
    rng = np.random.default_rng(11)
    text = (bytes(rng.integers(97, 101, size=3000, dtype=np.uint8))
            if corpus == "small" else dna_10k)
    queries = _queries(text, rng)
    (start, count), (j_start, j_count), stride1 = _both(text, queries,
                                                        key_words)
    assert stride1 == (corpus == "small")
    assert np.array_equal(count, j_count)
    assert np.array_equal(start, j_start)
    # and the semantics: count = overlapping occurrences
    for q, c in zip(queries, count.tolist()):
        want = (0 if not q else
                sum(text.startswith(q, i) for i in range(len(text))))
        assert c == want, q


def test_unicode_and_tiny_text():
    text = "☃abc☃ banana ☃".encode()
    queries = ["☃".encode(), b"ana", b"\x98", b"", text, text + b"x"]
    (start, count), (j_start, j_count), stride1 = _both(text, queries,
                                                        search2.KEY_WORDS)
    assert stride1
    assert np.array_equal(count, j_count) and np.array_equal(start, j_start)
    sa = naive_table(text)
    assert sorted(sa[start[0]:start[0] + count[0]].tolist()) == [0, 6, 17]


def test_fence_stride_ladder():
    assert [search2._fence_stride(1 << k) for k in (4, 12, 13, 22, 23, 24, 25)] \
        == [jax_search2._fence_stride(1 << k)
            for k in (4, 12, 13, 22, 23, 24, 25)]


def test_pack_queries_matches_jax():
    qs = ["", "a", "☃abc", b"\x00\xff", "x" * 20]
    got = pack_queries(qs)
    want = jax_search.pack_queries(qs)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
