"""Port multi-key sort: ``lexsort`` against ``numpy.lexsort``.

Both are stable, so the permutations must be identical, not only the
sorted keys. Keys carry heavy ties and the -1 / INF / int32-min extremes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch.ops.sort import lexsort, lexsort_perm  # noqa: E402

INF = 0x7FFFFFFF
EXTREMES = np.array([-(1 << 31), -1, 0, 1, 2, 3, INF - 1, INF], np.int64)


def _keys(rng, n_keys: int, n: int, dtypes):
    keys = []
    for j in range(n_keys):
        if j % 2:
            k = rng.choice(EXTREMES, size=n)
        else:
            k = rng.integers(-2, 3, size=n)
        keys.append(k.astype(dtypes[j % len(dtypes)]))
    return keys


@pytest.mark.parametrize("dtypes", [(np.int32,), (np.int32, np.int64)],
                         ids=["int32", "mixed"])
@pytest.mark.parametrize("n_keys", [1, 2, 3, 4, 5])
def test_lexsort_matches_numpy(n_keys, dtypes):
    rng = np.random.default_rng(100 + n_keys)
    n = 3001
    keys = _keys(rng, n_keys, n, dtypes)
    payload = rng.integers(0, 1 << 30, size=n).astype(np.int32)
    want = np.lexsort(keys[::-1])  # numpy: last key is the primary one
    got = lexsort([torch.from_numpy(k) for k in keys],
                  (torch.from_numpy(payload),))
    assert len(got) == n_keys + 1
    for k, g in zip(keys, got[:n_keys]):
        assert np.array_equal(g.numpy(), k[want])
    assert np.array_equal(got[-1].numpy(), payload[want])
    perm = lexsort_perm([torch.from_numpy(k) for k in keys])
    assert np.array_equal(perm.numpy(), want)


def test_lexsort_empty():
    empty = torch.zeros(0, dtype=torch.int32)
    (k,) = lexsort([empty])
    assert k.numel() == 0
