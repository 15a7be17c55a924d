"""The reference agrees with brute force on small texts, and its control
(suffixes read to 16 bytes) fails where a run would."""

import numpy as np
import pytest
import torch

from benchmark import reference
from benchmark.rng import generator


def naive_sa(text: bytes) -> list[int]:
    return sorted(range(len(text)), key=lambda i: text[i:])


def texts():
    rng = generator(5, 5)
    yield b"banana"
    yield b"mississippi"
    yield b"aaaaaaaaaa"
    yield b"\x00\xff\x00\xff\x80\x00"
    for n, sigma in [(300, 2), (500, 4), (400, 256)]:
        yield bytes(rng.integers(0, sigma, n, dtype=np.uint8))


@pytest.mark.parametrize("text", list(texts()))
def test_certificate_against_brute_force(text):
    t = reference.as_text(text, "cpu")
    sa = naive_sa(text)
    assert reference.sa_defects(t, np.array(sa, np.uint32)) == 0
    if len(set(text)) > 1:
        bad = list(sa)
        i = next(k for k in range(len(bad) - 1)
                 if text[bad[k]] != text[bad[k + 1]])
        bad[i], bad[i + 1] = bad[i + 1], bad[i]
        assert reference.sa_defects(t, np.array(bad)) > 0
    rot = sa[1:] + sa[:1]  # a permutation, out of order
    assert reference.sa_defects(t, np.array(rot)) > 0


def test_certificate_rejects_non_permutations():
    t = reference.as_text(b"abcabc", "cpu")
    assert reference.sa_defects(t, np.array([0, 0, 1, 2, 3, 4])) > 0
    assert reference.sa_defects(t, np.array([0, 1, 2])) > 0
    assert reference.sa_defects(t, np.arange(6)) > 0


def test_control_sa_sorts_by_the_first_bytes_only():
    rng = generator(1, 2)
    text = bytes(rng.integers(97, 101, 3000, dtype=np.uint8))
    t = reference.as_text(text, "cpu")
    sa = reference.control_sa(t, width=3)
    keys = [text[i:i + 3].ljust(3, b"\0") for i in sa]
    assert keys == sorted(keys)
    assert sorted(sa.tolist()) == list(range(len(text)))


@pytest.mark.parametrize("name", ["dna_200m", "english_200m"])
def test_control_fails_at_a_size_a_test_holds(name):
    """The control at 1 MiB of each configuration, with a short ladder of
    repeats: suffixes that share 16 bytes are left in position order, so
    its suffix table fails the certificate."""
    import json

    from benchmark.corpora import repeats
    from benchmark.spec import BENCH, ROOT
    from conftest import small_config

    torch.set_num_threads(1)
    cfg = json.loads((ROOT / BENCH / "configs" / f"{name}.json").read_text())
    cfg = {**cfg, **small_config(cfg, 1 << 20)}
    t = reference.as_text(repeats.make(cfg, 77, 0, "cpu"), "cpu")
    assert reference.sa_defects(t, reference.control_sa(t)) > 0
    assert reference.sa_defects(t, reference.control_sa(t, width=320)) == 0
