"""Port SA-IS engine against the JAX package's and the naive oracle.

Components (classify_types, run_decompose, bucket_layout, the inner
recursion level) are held against their ``suffix_tpu.ops.sais``
counterparts on the same padded inputs; the whole recursive engine
against the oracle, the golden SA digests and JAX on ``dna_10k``; the
hybrid ``suffix_array_sais`` (LMS ranks from the doubling engine) and
its ``_lms_class_rank_from_doubling`` against JAX's and the oracle, the
cases of ``tests/test_sais.py``. Tolerance: exact equality (every array
is integer).
"""

import hashlib
import pathlib

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from suffix_tpu.ops import sais as jax_sais  # noqa: E402
from suffix_torch.ops import sais  # noqa: E402
from suffix_torch.ops.naive import naive_table  # noqa: E402
from suffix_torch.ops.padding import PAD, bucket_size  # noqa: E402

FIXTURES = pathlib.Path(__file__).parent / "fixtures"
GOLDEN_SA = {
    "AP009048_10000":
        "335641df720e6a760955d891723fa48fc1554248ac89a44b1a3f4a36eaa0fdc3",
    "AP009048_100000":
        "d674074d481d76d7ac4e4ae4fe5df93a458a3b6fcb483ac92190babc52029694",
}

CORPORA = [b"banana", b"mississippi", b"aab", b"tgtgtgtgcaccg",
           b"\x00\xff\x00", b"cabbage", b"zyxwv", b"aaabbc"]

DIRECTED = [b"banana", b"mississippi", b"apple", b"tgtgtgtgcaccg", b"a",
            b"aa", b"ab", b"ba", b"\x00", b"abcabcabc", b"zzzzza",
            b"azzzzz", b"aaaaabaaaaab", bytes(range(256)),
            bytes(reversed(range(256))), "☃abc☃".encode()]

TRICKY = [b"mmiissiissiippii", b"baabaabac", b"abaabababbabbb", b"cabbage",
          b"aacaacaab", b"abab", b"abaaba", b"yabbadabbado",
          b"aaabbbcccdddaaa", b"zzyzxzyzyx"]


def _padded(b: bytes) -> np.ndarray:
    out = np.full(bucket_size(len(b)), PAD, np.int32)
    out[: len(b)] = np.frombuffer(b, np.uint8)
    return out


def _np(x) -> np.ndarray:
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _sa(b: bytes, **kw) -> np.ndarray:
    return sais.suffix_array_sais_recursive(b, device="cpu", **kw)


@pytest.mark.parametrize("text", CORPORA, ids=lambda b: repr(b)[:16])
def test_components_match_jax(text):
    t = _padded(text)
    port_t, jax_t = torch.from_numpy(t), jnp.asarray(t)
    for got, want in zip(sais.classify_types(port_t),
                         jax_sais.classify_types(jax_t)):
        assert np.array_equal(_np(got), _np(want))
    for got, want in zip(sais.run_decompose(port_t),
                         jax_sais.run_decompose(jax_t)):
        assert np.array_equal(_np(got), _np(want))
    for got, want in zip(sais.bucket_layout(port_t),
                         jax_sais.bucket_layout(jax_t)):
        assert np.array_equal(_np(got), _np(want))


def test_run_decompose_values():
    m, gamma = sais.run_decompose(torch.from_numpy(_padded(b"aaabbc")[:6]))
    assert m.tolist() == [3, 2, 1, 2, 1, 1]
    assert gamma.tolist() == [3, 3, 3, 5, 5, 6]


def test_inner_level_matches_jax():
    rng = np.random.default_rng(7)
    for n, hi in [(5, 2), (13, 3), (29, 5), (64, 9), (200, 4)]:
        padded = np.full(bucket_size(n), -1, np.int32)
        padded[:n] = rng.integers(0, hi, size=n)
        got = sais._sa_padded_sais_ints(torch.from_numpy(padded), depth=1)
        dev = jnp.asarray(padded)
        want = np.asarray(jax_sais._sa_padded_sais_ints(dev, depth=1))
        assert np.array_equal(got.numpy(), want), (n, hi)
        assert np.array_equal(
            got.numpy(), np.asarray(jax_sais._suffix_array_ints(dev)))


@pytest.mark.parametrize("text", DIRECTED + TRICKY, ids=lambda b: repr(b)[:16])
def test_recursive_vs_oracle(text):
    assert np.array_equal(_sa(text), naive_table(text))


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=0, max_size=96))
def test_prop_recursive_vs_oracle(b):
    assert np.array_equal(_sa(b), naive_table(b))


@settings(max_examples=40, deadline=None)
@given(st.text(alphabet="ab", min_size=1, max_size=72))
def test_prop_recursive_binary_alphabet(s):
    b = s.encode()
    assert np.array_equal(_sa(b), naive_table(b))


def _fib_word(k: int) -> bytes:
    a, b = "a", "ab"
    for _ in range(k):
        a, b = b, b + a
    return b.encode()


def _thue_morse(k: int) -> bytes:
    s = "0"
    for _ in range(k):
        s = s + "".join("1" if c == "0" else "0" for c in s)
    return s.encode()


@pytest.mark.parametrize("text", [
    _fib_word(10), _thue_morse(8), _fib_word(14),
    b"abcabcabcabcabcabcabcabcabcabd" * 4,
], ids=["fibonacci", "thue_morse", "fibonacci_big", "period3"])
def test_recursion_depth_matches_jax(text):
    got_stats, want_stats = {}, {}
    got = _sa(text, stats=got_stats)
    want = jax_sais.suffix_array_sais_recursive(text, stats=want_stats)
    assert np.array_equal(got, want)
    assert np.array_equal(got, naive_table(text))
    assert got_stats["depth"] == want_stats["depth"]
    assert got_stats["l_rounds"] > 0 and got_stats["substring_rounds"] > 0


@pytest.mark.parametrize("name", sorted(GOLDEN_SA))
def test_golden_digest(name):
    data = (FIXTURES / f"{name}.fasta").read_bytes()
    digest = hashlib.sha256(_sa(data).astype(np.uint32).tobytes())
    assert digest.hexdigest() == GOLDEN_SA[name]


def test_matches_jax_on_dna_10k(dna_10k):
    assert np.array_equal(
        _sa(dna_10k), jax_sais.suffix_array_sais_recursive(dna_10k))


def test_empty_text():
    assert _sa(b"").shape == (0,)


# ---- the hybrid pipeline (tests/test_sais.py) ----

def _hybrid(b: bytes) -> np.ndarray:
    return sais.suffix_array_sais(b, device="cpu")


@pytest.mark.parametrize("text", DIRECTED, ids=lambda b: repr(b)[:16])
def test_hybrid_directed(text):
    got = _hybrid(text)
    assert got.dtype == np.uint32
    assert np.array_equal(got, naive_table(text))
    assert np.array_equal(got, jax_sais.suffix_array_sais(text))


@settings(max_examples=60, deadline=None)
@given(st.binary(min_size=1, max_size=96))
def test_prop_hybrid(b):
    assert np.array_equal(_hybrid(b), naive_table(b))


@settings(max_examples=40, deadline=None)
@given(st.text(alphabet="ab\x00", min_size=1, max_size=64))
def test_prop_hybrid_small_alphabet(s):
    b = s.encode()
    assert np.array_equal(_hybrid(b), naive_table(b))


def test_hybrid_dna(dna_10k):
    got = _hybrid(dna_10k)
    assert np.array_equal(got, jax_sais.suffix_array_sais(dna_10k))
    assert np.array_equal(got, _sa(dna_10k))


def test_hybrid_descending_chain():
    b = bytes(range(255, -1, -1)) * 2
    assert np.array_equal(_hybrid(b), naive_table(b))


@pytest.mark.parametrize("text", CORPORA + TRICKY[:4],
                         ids=lambda b: repr(b)[:16])
def test_lms_class_rank_from_doubling_matches_jax(text):
    padded = _padded(text)
    got = sais._lms_class_rank_from_doubling(torch.from_numpy(padded))
    want = jax_sais._lms_class_rank_from_doubling(jnp.asarray(padded))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_hybrid_empty_text():
    assert _hybrid(b"").shape == (0,) and _hybrid(b"").dtype == np.uint32
