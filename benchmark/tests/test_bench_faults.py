"""A run whose timed path is broken underneath reads ``correct`` false:
the harness drives the rest of a run on the CPU (no look for a card),
with the program patched to commit each fault a cell can have. A cell on
one card has no exchange between cards to leave out."""

import numpy as np
import pytest

from suffix_torch.table import SuffixTable

from conftest import tiny_run

INDEX = ["dna200m.index", "english200m.index"]


@pytest.mark.parametrize("cell", INDEX)
def test_sound_run_is_correct(cell):
    out = tiny_run(cell)
    assert out["correct"], out["checks"]
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert out["attempted"] > 0


def patch_build(monkeypatch, change):
    orig = SuffixTable.new.__func__

    def broken(cls, text, *a, **k):
        st = orig(cls, text, *a, **k)
        return cls.from_parts(text, change(text, st.table().copy()),
                              device=st.device)

    monkeypatch.setattr(SuffixTable, "new", classmethod(broken))


def swapped(text, sa):
    i = len(sa) // 3  # an answer altered where it is produced
    sa[i], sa[i + 1] = sa[i + 1], sa[i]
    return sa


def unchanged(text, sa):
    return np.arange(len(sa), dtype=np.uint32)  # the input order


def half_sorted(text, sa):
    n = len(sa)  # the suffixes of the second half never sorted
    first = sa[sa < n // 2]
    return np.concatenate([first, np.arange(n // 2, n, dtype=np.uint32)])


@pytest.mark.parametrize("cell", INDEX)
@pytest.mark.parametrize("fault", [swapped, unchanged, half_sorted])
def test_index_faults(monkeypatch, cell, fault):
    patch_build(monkeypatch, fault)
    out = tiny_run(cell)
    assert not out["correct"]
    assert out["checks"]["sa_defects"]["value"] > 0
