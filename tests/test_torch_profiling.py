"""The port's recorder (``suffix_torch/utils/profiling.py``) on the CPU:
roots, spans and counters, their bound and threads; the ``build`` root of
``SuffixTable.new`` with the spans and counters of the device engine
(``ops/prefix_doubling.py``) on the two-phase, the classic and the
patched route, against the round count that ``collect_stats=True``
reports; and the
spans by name in a ``torch.profiler`` trace of a build. No JAX."""

import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from suffix_torch import SuffixTable  # noqa: E402
from suffix_torch.ops import prefix_doubling as pd  # noqa: E402
from suffix_torch.utils import profiling as P  # noqa: E402

BUILD_SPANS = {"build.probe", "build.plan", "build.pack", "build.upload",
               "build.dispatch", "build.readback", "build.download",
               "build.finish"}


def new_roots(before: list[dict], name=None) -> list[dict]:
    seen = {r["id"] for r in before}
    return [r for r in P.finished(name) if r["id"] not in seen]


def test_spans_nest_under_their_root():
    before = P.finished()
    with P.root("job", size=3) as r:
        with P.span("a", k=1):
            with P.span("a.inner"):
                pass
        with P.span("a"):
            pass
        P.annotate(route="x")
    (got,) = new_roots(before)
    assert got["id"] == r.id and got["name"] == "job"
    assert got["attrs"] == {"size": 3, "route": "x"}
    assert got["error"] is False and got["seconds"] == pytest.approx(r.seconds)
    spans = {(s["name"], s["parent"]): s for s in got["spans"]}
    outer = [s for s in got["spans"] if s["name"] == "a"]
    assert [s["parent"] for s in outer] == [r.id, r.id]
    inner = spans[("a.inner", outer[0]["id"])]
    assert outer[0]["start_ns"] <= inner["start_ns"] <= inner["end_ns"]
    assert inner["end_ns"] <= outer[0]["end_ns"] <= got["end_ns"]
    assert outer[0]["attrs"] == {"k": 1}
    assert got["span_n"] == {"a": 2, "a.inner": 1}
    assert got["span_s"]["a"] == pytest.approx(sum(
        (s["end_ns"] - s["start_ns"]) / 1e9 for s in outer))
    assert len({s["id"] for s in got["spans"]} | {r.id}) == 4


def test_counters_attach_to_the_open_root():
    before = P.finished()
    with P.root("outer"):
        P.count("rounds")
        with P.span("s"):
            P.count("rounds", 2)
            with P.root("inner"):
                P.count("syncs")
                with P.span("t"):
                    pass
        P.count("bytes", 10)
    inner, outer = new_roots(before)
    assert inner["name"] == "inner" and outer["name"] == "outer"
    assert outer["counters"] == {"rounds": 3, "bytes": 10}
    assert inner["counters"] == {"syncs": 1}
    assert [s["name"] for s in inner["spans"]] == ["t"]
    assert [s["name"] for s in outer["spans"]] == ["s"]
    assert P.finished("inner")[-1]["id"] == inner["id"]


def test_no_root_records_nothing():
    before = P.finished()
    with P.span("alone"):
        P.count("rounds")
        P.annotate(route="x")
        with P.span("alone.inner"):
            pass
    assert new_roots(before) == []
    with P.root("after") as r:
        pass
    (got,) = new_roots(before)
    assert got["id"] == r.id and got["spans"] == [] and got["counters"] == {}


def test_exception_closes_the_span_with_error():
    before = P.finished()
    with pytest.raises(KeyError):
        with P.root("job"):
            with P.span("ok"):
                pass
            with P.span("bad"):
                raise KeyError("x")
    (got,) = new_roots(before)
    assert got["error"] is True
    assert {s["name"]: s["error"] for s in got["spans"]} == {"ok": False,
                                                            "bad": True}
    # The stack is empty again: a span now records nothing.
    with P.span("later"):
        pass
    assert new_roots(before) == [got]


def test_the_last_roots_are_kept():
    with P.root("bound.other") as other:
        pass
    for i in range(P.MAX_ROOTS + 44):
        with P.root("bound", i=i):
            P.count("i", i)
    got = P.finished("bound")
    assert len(got) == P.MAX_ROOTS
    # Each name keeps its own last roots: the others are not pushed out.
    assert P.finished("bound.other")[-1]["id"] == other.id
    assert [r["attrs"]["i"] for r in got] == list(range(44, P.MAX_ROOTS + 44))
    assert [r["counters"]["i"] for r in got] == [r["attrs"]["i"] for r in got]
    assert all(a["id"] < b["id"] for a, b in zip(got, got[1:]))


def test_threads_keep_separate_stacks():
    barrier = threading.Barrier(4)
    ids = {}

    def work(k):
        with P.root("thread", k=k) as r:
            ids[k] = r.id
            with P.span(f"s{k}"):
                barrier.wait()
                P.count("k", k)
                barrier.wait()
            barrier.wait()

    before = P.finished()
    threads = [threading.Thread(target=work, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    got = {r["attrs"]["k"]: r for r in new_roots(before, "thread")}
    assert sorted(got) == [0, 1, 2, 3]
    for k, r in got.items():
        assert r["id"] == ids[k]
        assert [(s["name"], s["parent"]) for s in r["spans"]] == [
            (f"s{k}", ids[k])]
        assert r["counters"] == {"k": k}


def dna(n: int, copy: tuple[int, int, int] | None = None) -> bytes:
    """Random ACGT-like bytes; ``copy`` = (src, dst, length) plants a
    repeat, whose LCP takes the rounds (the padding slots never tie)."""
    rng = np.random.default_rng(n)
    arr = rng.integers(0, 4, n, dtype=np.uint8) + 97
    if copy is not None:
        src, dst, length = copy
        arr[dst:dst + length] = arr[src:src + length]
    return arr.tobytes()


@pytest.mark.parametrize("two_phase", [True, False])
def test_build_root_spans_and_counters(monkeypatch, two_phase):
    # Just over 2^19 bytes: n_pad = 2^20 reaches TWO_PHASE_MIN, and the
    # period probe and the adaptive plan run (ADAPTIVE_PACK_MIN). A
    # planted 500-byte copy takes two rounds past the 40-byte initial sort.
    monkeypatch.setattr(pd, "TWO_PHASE_FORCE", two_phase)
    text = dna((1 << 19) + 4096, copy=(1000, 300_000, 500))
    before = P.finished()
    st = SuffixTable.new(text, device="cpu")
    (got,) = new_roots(before)
    assert got["name"] == "build" and not got["error"]
    route = "adaptive(3b x 40ch)" + ("+2phase" if two_phase else "")
    assert got["attrs"] == {"engine": "device", "route": route,
                            "n": len(text), "n_pad": 1 << 20}
    assert set(got["span_n"]) == BUILD_SPANS
    assert all(s["parent"] == got["id"] for s in got["spans"]
               if s["name"] != "build.readback")
    c = got["counters"]
    assert c["host_syncs"] == got["span_n"]["build.readback"]
    # A CPU build copies nothing between host and device.
    assert c["h2d_bytes"] == c["d2h_bytes"] == 0
    # Every second of the build lies in a layer's span, within 5 %.
    layers = sum(got["span_s"][k] for k in BUILD_SPANS
                 if k != "build.readback")
    assert layers == pytest.approx(got["seconds"], rel=0.05)

    stats_st = SuffixTable.new(text, device="cpu", collect_stats=True)
    assert np.array_equal(st.table(), stats_st.table())
    s = stats_st.build_stats
    (with_stats,) = new_roots(before + [got])
    if two_phase:
        h, phase1 = s["h0"], 0
        while h < s["h_phase1"]:
            h *= 4
            phase1 += 1
        assert h == s["h_phase1"]
        want = phase1 + s["phase2_rounds"]
        assert s["phase2_rounds"] >= 1
    else:
        want = s["rounds"]
    assert c.get("rounds", 0) == with_stats["counters"].get("rounds", 0)
    assert c.get("rounds", 0) == want == 2
    assert with_stats["counters"]["host_syncs"] == c["host_syncs"]
    assert c["pad_slots"] == (1 << 20) - len(text)


def test_patched_build_keeps_the_rotation_build_apart():
    # A 1,000-byte period with one defect, past ADAPTIVE_PACK_MIN: the
    # patched route, whose rotation width is a build of T[:2q] of its own.
    rng = np.random.default_rng(11)
    block = rng.integers(0, 26, 1000, dtype=np.uint8) + 97
    arr = np.tile(block, 132)[:(1 << 17) + 500].copy()
    arr[50_000] ^= 1
    text = arr.tobytes()
    before = P.finished("build") + P.finished("build.rotation")
    st = SuffixTable.new(text, device="cpu")
    (got,) = new_roots(before, "build")
    (rot,) = new_roots(before, "build.rotation")
    assert got["attrs"]["route"].startswith("patched(q=1000,")
    assert got["attrs"]["n_pad"] == 1 << 18 and rot["attrs"]["n"] == 2000
    assert rot["attrs"]["route"].startswith("ladder(")
    assert got["start_ns"] <= rot["start_ns"] <= rot["end_ns"] <= got["end_ns"]
    # The rotation build lies inside the job's probe, in spans of its own.
    assert any(s["start_ns"] <= rot["start_ns"] <= rot["end_ns"] <= s["end_ns"]
               for s in got["spans"] if s["name"] == "build.probe")
    assert {"build.dispatch", "build.readback"} <= set(rot["span_n"])
    assert set(got["span_n"]) == BUILD_SPANS
    c = got["counters"]
    assert c["host_syncs"] == got["span_n"]["build.readback"]
    assert rot["counters"]["host_syncs"] == rot["span_n"]["build.readback"]

    stats_st = SuffixTable.new(text, device="cpu", collect_stats=True)
    assert np.array_equal(st.table(), stats_st.table())
    (with_stats,) = new_roots(before + [got], "build")
    # Phase A often reaches purity at its first sort (no round, no
    # counter); the rotation build's own rounds stay in its root.
    want = stats_st.build_stats["rounds"]
    assert c.get("rounds", 0) == with_stats["counters"].get("rounds", 0)
    assert c.get("rounds", 0) == want
    assert rot["counters"]["rounds"] >= 1


def test_build_spans_in_a_device_trace(tmp_path, monkeypatch):
    for name, value in (("ADAPTIVE_PACK_MIN", 16), ("TWO_PHASE_MIN", 16),
                        ("TWO_PHASE_FORCE", True)):
        monkeypatch.setattr(pd, name, value)
    # n_pad 4096: a planted 600-byte copy carries phase 1 past one round
    # (its tie mass over n_pad / 8 at depths 30 and 120) into phase 2.
    text = dna(2400, copy=(100, 1300, 600))
    with P.device_trace(str(tmp_path)):
        st = SuffixTable.new(text, device="cpu")
    assert st.verify()
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    want = {"build"} | BUILD_SPANS | {
        "P0_dense_pack", "P1_initial_sort", "P2_initial_rank",
        "P3_shift_ranks", "P4_round_sort", "P5_dense_rerank",
        "P6_route_home", "T1_to_positional", "T2_phase2_round",
        "T3_final_sa"}
    assert want <= names, want - names


@pytest.mark.parametrize("n,n_pad", [(5000, 8192), (8192, 8192),
                                     ((1 << 17) + 9, 1 << 18)])
def test_pad_slots_counts_the_keyed_padding(n, n_pad):
    text = dna(n, copy=(10, n // 2, 100))
    before = P.finished()
    st = SuffixTable.new(text, device="cpu")
    (got,) = new_roots(before)
    assert got["attrs"]["n_pad"] == n_pad
    assert got["counters"]["pad_slots"] == n_pad - n
    assert got["counters"]["rounds"] >= 1
    assert st.verify()


@pytest.mark.parametrize("n,route", [((1 << 17) + 300, "adaptive("),
                                     (5000, "ladder(")])
def test_dispatch_leaves_the_staged_input(monkeypatch, n, route):
    """The padding keys are made in the engine's own words: the staged
    input is unchanged after a dispatch, and the closure dispatches again
    to the same array (the adaptive and the ladder route)."""
    staged = []
    upload = pd._upload

    def keep(host, device):
        staged.append(upload(host, device))
        return staged[-1]

    monkeypatch.setattr(pd, "_upload", keep)
    arr = np.frombuffer(dna(n, copy=(100, 3000, 200)), np.uint8)
    n_pad = pd.bucket_size(n)
    dispatch, label = pd.device_build_closure(arr, n_pad, device="cpu")
    assert label.startswith(route)
    (t_dev,) = staged
    host = t_dev.clone()
    with P.root("dispatch.twice"):
        first = dispatch().clone()
        assert torch.equal(t_dev, host)
        assert torch.equal(dispatch(), first)
    assert torch.equal(t_dev, host)
    (root,) = P.finished("dispatch.twice")[-1:]
    assert root["counters"]["pad_slots"] == 2 * (n_pad - arr.size)
    want = pd.suffix_array_bytes(arr, device="cpu")
    assert np.array_equal(first[n_pad - arr.size:].numpy(), want)
