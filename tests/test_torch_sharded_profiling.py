"""The sharded build's spans and counters (``parallel/dist_build.py``
through ``utils/profiling.py``), in one 4-rank gloo world started by
``launch.spawn``.

Each ``build_table`` call is one ``sharded_build`` root on every rank.
The world builds texts of ``english_1g``'s shape (the benchmark's
generator, its ladder scaled down): one fills its blocks and takes the
coded first round, as its words do at this size; one is padded below
the plan's size floor and takes the packed 3-byte keys; a 4-letter text
takes the coded round too; a text whose four blocks have different
alphabets checks the plan from the ranks' own byte counts; and a stepped
build has a checkpoint. Each rank counts the engine's rounds by wrapping its
round functions, and reports its root; rank 0's report of every rank
comes back to the tests. Tolerance: exact equality.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once.
torch.set_num_threads(1)

from suffix_torch.ops.prefix_doubling import (  # noqa: E402
    ADAPTIVE_PACK_MIN, suffix_array_bytes)
from suffix_torch.parallel import dist_build as db  # noqa: E402
from suffix_torch.parallel import launch  # noqa: E402
from suffix_torch.ops.sort import lexsort  # noqa: E402

WORLD = 4
SPANS = ("sharded.plan", "sharded.stage", "sharded.rounds",
         "sharded.exchange", "sharded.gather", "sharded.finish")
CASES = ("english_full", "english_padded", "dna_coded", "mixed_blocks",
         "english_stepped")


def english_text(n: int, seed: int) -> bytes:
    """``english_1g``'s shape at ``n`` bytes: its words, its 142 rare
    bytes once each, and a short ladder of exact copies."""
    from benchmark.corpora import repeats
    from benchmark.spec import BENCH, ROOT

    cfg = json.loads((ROOT / BENCH / "configs" / "english_1g.json")
                     .read_text())
    cfg.update(n_bytes=n, repeats=[[3000, 1], [500, 5], [100, 20]],
               sprinkle={**cfg["sprinkle"], "count": 1})
    return repeats.make(cfg, seed, 0, "cpu")


def dna_text(n: int) -> bytes:
    rng = np.random.default_rng(n)
    t = rng.integers(0, 4, n, dtype=np.uint8)
    t[5000:6500] = t[70000:71500]  # a repeat past the coded key window
    return (np.frombuffer(b"ACGT", np.uint8)[t]).tobytes()


def mixed_text(n: int) -> bytes:
    """Four blocks over four alphabets: no rank's own bytes give the
    whole text's byte counts."""
    rng = np.random.default_rng(n + 1)
    alphabets = (b"ACGT", b"acgtn", b"0123456789", b" .,;:!?-")
    return b"".join(
        np.frombuffer(a, np.uint8)[rng.integers(0, len(a), n // 4)].tobytes()
        for a in alphabets)


def texts() -> dict:
    return {"english_full": english_text(1 << 17, 2**31 + 16),
            "english_padded": english_text(60_000, 2**31 + 17),
            "dna_coded": dna_text(1 << 17),
            "mixed_blocks": mixed_text(1 << 17),
            "english_stepped": english_text(1 << 17, 2**31 + 18)}


def _world(mesh, cases: dict, ckpt: str):
    """Every case on each rank; rank 0 gets every rank's reports."""
    import torch.distributed as dist

    from suffix_torch.utils.profiling import finished

    engine_rounds = [0]
    body, first = db._round_body, db._coded_first_round

    def counted(fn):
        def wrapped(*a, **k):
            engine_rounds[0] += 1
            return fn(*a, **k)
        return wrapped

    db._round_body, db._coded_first_round = counted(body), counted(first)
    out = {}
    try:
        for name, text in cases.items():
            before = len(finished("sharded_build"))
            engine_rounds[0] = 0
            sa = db.build_table(mesh, text, checkpoint_path=(
                ckpt if name == "english_stepped" else None))
            roots = finished("sharded_build")
            r = roots[-1]
            arr = np.frombuffer(text, np.uint8)
            n_local = db._local_bucket(len(arr), mesh.world_size)
            lo = mesh.rank * n_local
            report = {"plan_of_blocks": db._sharded_adaptive_plan(
                          arr, n_local * mesh.world_size, n_local, mesh),
                      "block_counts": np.bincount(arr[lo:lo + n_local],
                                                  minlength=256),
                      "new_roots": len(roots) - before,
                      "attrs": r["attrs"], "counters": r["counters"],
                      "span_n": r["span_n"],
                      "engine_rounds": engine_rounds[0],
                      "sa": sa if mesh.rank == 0 else None}
            seen = [None] * mesh.world_size
            dist.all_gather_object(seen, report, group=mesh.group)
            out[name] = seen
    finally:
        db._round_body, db._coded_first_round = body, first
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ckpt = str(tmp_path_factory.mktemp("sharded_prof") / "ck.npz")
    cases = texts()
    return cases, launch.spawn(_world, WORLD, cases, ckpt, device="cpu")


def plan_words(text: bytes):
    """The coded first round's word count, or None (packed)."""
    arr = np.frombuffer(text, np.uint8)
    n_local = db._local_bucket(len(arr), WORLD)
    plan = db._sharded_adaptive_plan(arr, n_local * WORLD, n_local)
    return None if plan is None else plan[1][0]


@pytest.mark.parametrize("case", CASES)
def test_one_root_a_build_on_every_rank(world, case):
    cases, out = world
    n = len(cases[case])
    n_local = db._local_bucket(n, WORLD)
    for rank, rep in enumerate(out[case]):
        assert rep["new_roots"] == 1
        attrs = rep["attrs"]
        assert (attrs["rank"], attrs["world"], attrs["n"],
                attrs["n_total"]) == (rank, WORLD, n, n_local * WORLD)
        want = "packed" if plan_words(cases[case]) is None else "coded"
        assert attrs["route"] == want


def test_routes_cover_both_first_rounds(world):
    _, out = world
    assert out["english_padded"][0]["attrs"]["route"] == "packed"
    assert out["dna_coded"][0]["attrs"]["route"] == "coded"


@pytest.mark.parametrize("case", CASES)
def test_rounds_and_stages_are_the_engines(world, case):
    _, out = world
    stages = 3  # log2(4) * (log2(4) + 1) / 2 merge-splits a global sort
    for rep in out[case]:
        c = rep["counters"]
        assert c["rounds"] == rep["engine_rounds"] > 0
        # A round's sort of the keys and its sort home.
        assert c["merge_stages"] == 2 * stages * c["rounds"]
        # One readback of ``done`` a round, one copy a gathered block,
        # and the summed byte counts where the plan runs.
        planned = rep["attrs"]["n_total"] >= ADAPTIVE_PACK_MIN
        assert c["host_syncs"] == c["rounds"] + WORLD + planned


@pytest.mark.parametrize("case", CASES)
def test_exchange_bytes_of_rank_0(world, case):
    """Rank 0 sends no halo (its neighbours on the left do not exist):
    its bytes are the merge-splits' blocks, the boundary rows, the flag
    counts and the table's all-gather."""
    cases, out = world
    n_local = db._local_bucket(len(cases[case]), WORLD)
    c = out[case][0]["counters"]
    rounds, stages, item = c["rounds"], 3, 4  # int32 rows
    block = n_local * item
    per_round = (stages * 5 * block + 4 * 8 + (WORLD - 1) * item
                 + stages * 2 * block)
    want = rounds * per_round + (WORLD - 1) * block
    words = plan_words(cases[case])
    if words is not None:
        # The coded first round sorts its words and the index, and
        # compares its words with the left neighbour's last row.
        want -= (stages * 5 * block + 4 * 8) - (stages * (words + 1) * block
                                                + words * 8)
    assert c["exchange_bytes"] == want


@pytest.mark.parametrize("span", SPANS)
def test_every_span_is_recorded(world, span):
    _, out = world
    for case in CASES:
        for rep in out[case]:
            assert rep["span_n"].get(span, 0) >= 1, (case, span)
    rep = out["english_full"][0]
    assert rep["span_n"]["sharded.exchange"] > rep["counters"]["rounds"]


@pytest.mark.parametrize("case", CASES)
def test_rank0_table_is_certified_and_the_single_engines(world, case):
    from benchmark import reference

    cases, out = world
    text = cases[case]
    sa = out[case][0]["sa"]
    assert reference.sa_defects(reference.as_text(text, "cpu"), sa) == 0
    assert np.array_equal(sa, suffix_array_bytes(text, device="cpu"))


@pytest.mark.parametrize("case", CASES)
def test_plan_of_the_ranks_blocks_is_the_whole_texts(world, case):
    """Each rank counts its own block's bytes and one all-reduce sums
    them: the plan is the one of the whole text's counts."""
    cases, out = world
    arr = np.frombuffer(cases[case], np.uint8)
    n_local = db._local_bucket(len(arr), WORLD)
    whole = db._sharded_adaptive_plan(arr, n_local * WORLD, n_local)
    for rep in out[case]:
        got = rep["plan_of_blocks"]
        assert (got is None) == (whole is None)
        if whole is not None:
            assert np.array_equal(got[0], whole[0]) and got[1] == whole[1]
    if case == "mixed_blocks":
        counts = [rep["block_counts"] for rep in out[case]]
        assert whole is not None
        assert all(not np.array_equal(c > 0, counts[0] > 0)
                   for c in counts[1:])


@pytest.mark.parametrize("keep_low", [True, False])
@pytest.mark.parametrize("layout", ["round", "coded", "home"])
def test_merge_split_keeps_the_half_of_the_sorted_rows(layout, keep_low):
    """A merge-split's kept rows are the low or the high half of the two
    blocks' rows in sorted order: the round's four rank columns (many
    ties) and the index, the coded round's int64 words and the index,
    and the sort home's index key with a payload."""
    g = torch.Generator().manual_seed(7)
    n = 1 << 11
    idx = torch.randperm(2 * n, generator=g).to(torch.int32)
    if layout == "round":
        keys = [torch.randint(-1, 6, (2 * n,), generator=g,
                              dtype=torch.int32) for _ in range(4)] + [idx]
        pays = []
    elif layout == "coded":
        keys = [torch.randint(0, 1 << 40, (2 * n,), generator=g)
                for _ in range(2)] + [idx]
        pays = []
    else:
        keys = [idx]
        pays = [torch.randint(0, 100, (2 * n,), generator=g,
                              dtype=torch.int32)]
    rows = keys + pays
    side = torch.randperm(2 * n, generator=g)
    lower = list(lexsort([c[side[:n]] for c in keys],
                         [c[side[:n]] for c in pays]))
    upper = list(lexsort([c[side[n:]] for c in keys],
                         [c[side[n:]] for c in pays]))
    kept = db._merge_split(lower, upper, len(keys), keep_low)
    got = lexsort(kept[:len(keys)], kept[len(keys):])
    want = lexsort(rows[:len(keys)], rows[len(keys):])
    half = slice(0, n) if keep_low else slice(n, 2 * n)
    for a, b in zip(got, want):
        assert torch.equal(a, b[half])
