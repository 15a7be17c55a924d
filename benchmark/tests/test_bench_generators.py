"""The generators repeat by seed, give every seed the same work, and hold
a text to the alphabet and repeats its configuration states."""

import json

import numpy as np
import pytest

from benchmark.corpora import repeats
from benchmark.rng import generator, stream_seed
from benchmark.spec import BENCH, ROOT
from conftest import small_config

BIG_SEED = 2**31 + 12345
CONFIGS = ["dna_200m", "english_200m"]


def config(name, n_bytes=20000, **more):
    cfg = json.loads((ROOT / BENCH / "configs" / f"{name}.json").read_text())
    return {**cfg, **small_config(cfg, n_bytes), **more}


def suffix_array(text: bytes) -> np.ndarray:
    """Prefix doubling in NumPy."""
    n = len(text)
    rank = np.frombuffer(text, np.uint8).astype(np.int64)
    k = 1
    while True:
        nxt = np.full(n, -1, np.int64)
        nxt[:n - k] = rank[k:]
        sa = np.lexsort((nxt, rank))
        key = np.stack([rank[sa], nxt[sa]])
        new = np.empty(n, np.int64)
        new[sa] = np.cumsum(np.r_[0, np.any(key[:, 1:] != key[:, :-1], 0)])
        rank = new
        if rank.max() == n - 1:
            return sa
        k *= 2


def lcp_array(text: bytes, sa) -> np.ndarray:
    """Kasai's LCP, ``lcp[i]`` of ranks ``i-1`` and ``i``."""
    n = len(text)
    rank = np.empty(n, np.int64)
    rank[sa] = np.arange(n)
    lcp = np.zeros(n, np.int64)
    h = 0
    for i in range(n):
        if rank[i] > 0:
            j = sa[rank[i] - 1]
            while i + h < n and j + h < n and text[i + h] == text[j + h]:
                h += 1
            lcp[rank[i]] = h
            h = max(h - 1, 0)
        else:
            h = 0
    return lcp


@pytest.mark.parametrize("name", CONFIGS)
def test_corpus_repeats_by_seed(name):
    cfg = config(name)
    a = repeats.make(cfg, BIG_SEED, 0, "cpu")
    assert a == repeats.make(cfg, BIG_SEED, 0, "cpu")
    assert len(a) == cfg["n_bytes"]
    assert a != repeats.make(cfg, BIG_SEED + 1, 0, "cpu")
    assert a != repeats.make(cfg, BIG_SEED, 1, "cpu")


@pytest.mark.parametrize("name", CONFIGS)
def test_every_seed_gets_the_same_work(name):
    cfg = config(name)
    src, dst, ln = repeats.repeat_slots(cfg, cfg["n_bytes"], generator(1, 9))
    src2, dst2, ln2 = repeats.repeat_slots(cfg, cfg["n_bytes"],
                                           generator(2, 9))
    assert ln.tolist() == ln2.tolist()
    assert sorted(ln.tolist()) == sorted(
        [length for length, count in cfg["repeats"] for _ in range(count)])
    assert not np.array_equal(src, src2)
    # Slots (body and side bytes) are disjoint and inside the text.
    lo = np.concatenate([src, dst]) - 1
    hi = np.concatenate([src, dst]) + np.concatenate([ln, ln]) + 1
    order = np.argsort(lo)
    assert lo.min() >= 0 and hi.max() <= cfg["n_bytes"]
    assert np.all(lo[order][1:] >= hi[order][:-1])


def test_dna_alphabet_is_the_stated_one():
    cfg = config("dna_200m")
    text = repeats.make(cfg, 7, 0, "cpu")
    assert len(set(text)) == 16
    assert set(text) == set(b"ACGTN" + cfg["sprinkle"]["bytes"].encode())
    assert text.count(b"N" * 8) >= 1  # a copy may write over a run


def test_english_alphabet_is_the_stated_one():
    cfg = config("english_200m", 1 << 20)
    text = repeats.make(cfg, 7, 0, "cpu")
    extra = set(repeats.byte_values(cfg["sprinkle"]["bytes"]))
    assert len(extra) == 142 and extra <= set(text)
    assert len(set(text)) == 225  # and the 83 bytes of the words


def test_words_have_the_published_shape():
    import torch

    text = repeats.make({"n_bytes": 1 << 18, "background": {"kind": "words"}},
                        3, 0, "cpu")
    assert len(set(text)) > 64  # letters of both cases, digits, UTF-8
    assert text.count(b" ") > len(text) // 10
    gen = torch.Generator().manual_seed(1)
    assert len(repeats.words.make(100, generator(1, 1), gen, "cpu")) == 100


@pytest.mark.parametrize("name", CONFIGS)
def test_repeats_set_the_max_and_the_mean_lcp(name):
    cfg = config(name, 6000, repeats=[[400, 1], [100, 3], [30, 10]])
    text = repeats.make(cfg, 11, 0, "cpu")
    lcp = lcp_array(text, suffix_array(text))
    assert lcp.max() == 400
    plain = lcp_array(*(lambda t: (t, suffix_array(t)))(
        repeats.make({**cfg, "repeats": []}, 11, 0, "cpu")))
    # A copy of length l puts l, l - 1, ..., 1 where a background LCP
    # stood: it adds l (l + 1) / 2 less l times the background's mean.
    added = sum(c * (length * (length + 1) / 2 - length * plain.mean())
                for length, c in cfg["repeats"])
    assert abs(int(lcp.sum()) - int(plain.sum()) - added) < 0.02 * added


def test_stream_seed_takes_large_seeds():
    assert stream_seed(2**70 + 3, 1) != stream_seed(3, 1)
    assert 0 <= stream_seed(-5, 2) < 2**63


def test_too_many_repeats_are_refused():
    with pytest.raises(ValueError):
        repeats.make(config("dna_200m", 1000, repeats=[[600, 1]]), 1, 0,
                     "cpu")
