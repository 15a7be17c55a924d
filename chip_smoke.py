#!/usr/bin/env python3
"""Drive the PyTorch port (``suffix_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   — CUDA present; torch/CUDA versions; card name and power limit.
2. build    — compile the CUDA kernels from ``suffix_torch/csrc`` (nvcc).
3. kernels  — byte_histogram against its plain PyTorch version on the card,
              exact equality: ragged and misaligned inputs (views x[1:],
              x[3:]; n of 1, 3, 4, 5, 17), out-of-range values at 258
              and 512 bins, the 4 MiB text's symbols, the histogram
              battery's five inputs (one bin at 2^22 among them), calls
              in a row and calls on two streams at once; one device
              operation a call (torch.profiler); the build log's
              registers, spills and shared memory, CTAs an SM and waves;
              then the histogram battery (ops/kernels.py), whose
              dna_s_sym row gives the kernel table's times: ``ms`` after
              the zeroing flush, ``library_ms`` torch.histc.
   kernels_main_path — byte_histogram at the default build's shape: 200
              MiB of random bytes staged as a build stages them (2^28
              int32 slots, the rest PAD), 256 bins, equal to its plain
              version, and the device byte counts equal to np.bincount;
              CUDA-event medians of the kernel, the plain version and
              torch.bincount, beside the bound at 3.35 TB/s.
   probes   — copy_blocks, copy5_blocks and minmax_stages against their
              plain versions at (2^15, 128) int32 from seed 3, ragged
              copies (less than one 32 KiB chunk, no multiple of it) and
              minmax_stages on both paths (the register path at 16, 2 and
              1 blocks; the shared path at five other shapes), exact
              equality; each kernel's registers, stack, spills and shared
              memory from the build log, and its CTAs an SM and waves at
              the battery's shape; then the bandwidth battery
              (ops/probes.py), whose run is the probes' path.
4. golden   — SA-IS build of the 100 KB E. coli fixture against its golden
              SA digest, with the pipeline's rounds per phase.
   golden_device — the default (doubling) build of both E. coli fixtures
              against their golden SA and LCP digests and the JAX
              package's route labels.
5. build_4m — SA-IS build of a 4 MiB random DNA text (seed 0xD4A),
              certified by the O(n) suffix-array certificate, with the
              pipeline's rounds per phase.
6. queries  — one count/positions batch of 262,144 14-byte queries drawn
              from the text, 4,096 random (mostly absent) ones, 256 of 24
              and of 48 bytes, and the empty query, checked against the raw
              bytes; queries per second.
7. profile  — torch.profiler over one more 4 MiB SA-IS build and one
              262,144-query batch: device busy share, top kernels, SA-IS
              phase scopes.
8. build_4m_device — the main path: the default build of the same text
              with build stats, certified, its byte_histogram launches
              counted (as in every default build below: one, the plan's
              byte counts; two in the near-repeated build, whose
              rotation build counts too); the phase-6 query batch on it
              (queries_device); then ``lcp_lens()``, 65,536 sampled
              adjacent pairs checked against their byte-wise common prefix.
   search_probe — the probe-chain engines on that table and its
              262,144-query battery: ``bounds_batch`` and
              ``bounds_batch_fast`` (with ``probe_lut``), every count and
              live start equal to the flat merge-join engine's; median
              seconds of 5 and q/s of each and of the merge-join.
   sais_hybrid — ``suffix_array_sais`` (LMS ranks from the doubling
              engine) on the same text, its digest the default build's.
9. build_64m_device — the default build of 64 MiB of random DNA, certified.
   lcp_64m — ``lcp_lens()`` on the 64 MiB table: the bulk ladder once and
              Kasai never (both counted by wrappers set here), a survivor
              census in (2048, n/64], the 65,536 sampled pairs and every
              pair with an LCP of 18 or more checked against the bytes
              (their number is the census); survivors per ladder stage;
              then profile_lcp_64m (L1..L4 scopes).
   build_4m_device_repeats, build_4m_device_text — the default build's
              other routes at 4 MiB, certified: DNA with planted 2 KiB
              repeats (quadrupling rounds) and lowercase text with planted
              repeats (two-phase).
   build_4m_device_nearrep — bench.py's near-repeated corpus (the 100 KB
              fixture tiled 45 times, cut to 2^22 bytes, 16 bytes XOR 1):
              the patched route ``patched(q=100001,defects=32)``,
              certified, with its phase-A stats.
10. profile_build_4m_device(_repeats, _text, _nearrep), profile_lcp_4m —
              torch.profiler over one more default build of each 4 MiB
              text (P0..P6, T1..T3 and PP_small_key scopes) and one LCP.
11. build_128m_text — 2^27 bytes of ``utils/textgen.py::text_corpus`` (the
              JAX bench's large corpus), route ``adaptive(7b x 24ch)+2phase``,
              certified.
   queries_128m_deep — the deep keyless index of that table (no flat
              keys; 8 fence and 6 ext words): bench.py's mixed battery of
              4-40-byte patterns at 16,384 and 131,072, 1,024 drawn 64-byte
              patterns (the byte tail past 42 bytes) and 1,024 random ones;
              every (start, count) equal to the flat-key engine's (12-word
              keys) on the same table, 4,096 bounds checked on the bytes;
              queries per second.
   serve_128m_deep — the serving runtime over that index: serve_tcp in
              a thread (127.0.0.1, port 0), 16 client threads, each
              sending one at a time 32 ``count`` requests of 256 patterns
              of the 131,072 battery and 8 ``positions`` requests of 16
              drawn 64-byte or random ones (base64), first through a
              Batcher(max_batch=131072, max_wait_ms=2), then without one;
              every answer equal to the table's own batch calls;
              requests/s, queries/s, p50/p99 request ms, queries per
              drained batch (a counting wrapper); then 256 and 4,096
              queries as one caller's batches.
   profile_queries_128m_deep_4096 — torch.profiler over one 4,096-query
              deep batch (a full drain's size).
   lean_128m — the lean keyless build's fences and blocks bit-equal to
              the one-program build's, with the peak memory of each.
12. native  — build the C++ library and CPython extension of
              ``suffix_torch/native`` (both must load), then both fixtures
              through ``engine="native"`` and ``lcp_lens("native")``
              against the golden digests.
   build_small_native — µs of one small native build (11, 64 and 1,024
              bytes) through the fast path and through ``__init__``,
              beside the C SA-IS and ``resolve_device(None)`` alone.
   build_4m_native — ``engine="auto"`` on the 4 MiB DNA text: label
              ``native-sais``, the default build's table.
   lcp_4m_nearrep, lcp_128m_text — ``lcp_lens()`` on the near-repeated
              and 128 MiB tables: the sampler's route to the native Kasai
              (wrappers count it once, the bulk ladder never), 65,536
              sampled pairs checked against the bytes.
   tree_4m  — ArraySuffixTree.from_suffix_table on the 4 MiB DNA and
              near-repeated tables (seconds, nodes, deepest node, peak
              memory) with the reference's three tree invariants; the
              100 KB fixture's arrays equal on the card and the CPU; the
              10 KB fixture's dot equal to the host fold's.
   queries_hybrid — 4,096 single queries of each method on the 4 MiB
              default-built table under ``query_route="auto"`` (the host
              route, the extension's methods bound onto the table) and
              1,024 under ``"device"``, every answer equal; a batch of 64
              on the host and 65 on the device (wrappers); median µs a
              call.
   verify_device — ``verify(device=True)`` against the host certificate
              on the 4 and 64 MiB tables and on a 4 MiB table with two
              entries swapped; seconds of each form.
13. the sharded build (``suffix_torch/parallel``) over a one-rank NCCL
   mesh in this process (``make_mesh(1)``):
   collective_bins — ``global_bucket_layout`` on the 64 MiB DNA text:
              counts, heads and tails equal to ``torch.bincount``; the
              byte_histogram counter set to 0 just before the call and
              read just after (one launch); the resident block's layout
              beside the plain histogram and ``bincount``.
   sharded_build — ``suffix_array_sharded`` on the 64 MiB DNA text (the
              single-device closure a one-rank mesh takes) and
              ``suffix_array_sharded_stepped`` (the SPMD round body) on
              it and on the 128 MiB text, every digest the default
              build's; seconds, rounds, peak memory.
   sharded_serve — ``ShardedQueryIndex`` (parallel/dist_query.py) over
              the same mesh: the 128 MiB text's device-resident index
              (``sa=None``: build, align, keys; seconds, peak over
              resident, bytes a position), its table the default build's;
              the queries_128m_deep battery, every (start, count) equal to
              the deep index's, queries per second; 256 patterns through
              the collective slice (one byte past MAX_SLICE_ELEMS), each
              slice the single-card table's, 16 as sets on the bytes, and
              ``any_position``; the sharded LCP of the 64 MiB DNA and the
              4 MiB near-repeated tables equal to lcp_64m's and
              lcp_4m_nearrep's (seconds, peak, rounds, survivors);
              ``SuffixTree.from_sharded`` on the 100 KB fixture equal to
              the host fold; ``dryrun_multichip(1)``.
   sharded_ckpt — the stepped build of the 4 MiB near-repeated corpus,
              checkpointed every round; a run stopped by its hook after
              round 3, then resumed: the same table, the rest of the
              rounds.
   sharded_multi — with two or more cards, worlds of 2 and (with four)
              4 NCCL ranks, one process a card (``launch.spawn``), on the
              64 MiB text: the one-shot and the stepped build, each digest
              the default build's, and the bucket layout (one
              byte_histogram launch a rank); the ShardedQueryIndex of the
              text (``sa=None``), its 16,384-pattern battery's bounds the
              one-rank index's and its LCP lcp_64m's, and
              ``dryrun_multichip`` over the world; with one card it prints
              that it did not run, and why.
14. cli     — ``python -m suffix_torch`` in subprocesses on the 4 MiB DNA
              text in a temporary directory: build --stats -o, build
              --engine sharded --devices 1 --checkpoint (its saved table
              the default build's), stree banana (JAX's dot, pinned) and
              warmup at once, then search (64 patterns, checked on the
              bytes), search --sharded --devices 1 (its stdout the plain
              search's), info (max LCP) and serve --tcp 0 --batch --warm
              (ping, count, quit) at once; each step's wall seconds.

byte_histogram's launch counter is set to 0 just before phase 5 and read
just after phase 6 (its path is the SA-IS build), again just before and
after each default build of build_device (the main path: the plan's
byte counts), and just before and after collective_bins' layout (the
sharded bucket layout); the kernel line's ``callers`` name each window's
launches. The probes' counters (minmax_stages' by path too) are set to 0
just before and read just after the battery, which must run the
register path. Besides the plan's byte counts the doubling and LCP path
runs library operations only, the native and hybrid phases host C++.
Every default build of a text of 2^17 padded slots or more counts its
bytes with byte_histogram, so it also launches outside the counted
windows: golden_device's 100 KB fixture, the profiled builds,
sais_hybrid's doubling derivation, and the one-rank mesh's builds in
sharded_build, sharded_serve and ``dryrun_multichip(1)`` (a one-rank
mesh runs ``device_build_closure``). The probe engines, the rest of the
sharded build (the stepped build, sharded_ckpt, and sharded_multi's
builds at two and four ranks, which count on the host), the serving and
tree phases run library operations and collectives and launch none of
the four kernels. Sharded serving adds no kernel: the JAX package's
``dist_query.py`` runs no Pallas kernel, only XLA sorts, gathers and
collectives, and its port runs library operations and
``torch.distributed`` calls.
The line before
the last is the kernel table (``{"kernels": [...]}``); the last line is
the device summary. Any failed
check raises, and the script exits non-zero without those two lines. It
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import base64
import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "AP009048_100000.fasta"
FIXTURE_10K = ROOT / "tests" / "fixtures" / "AP009048_10000.fasta"
GOLDEN_SA_100K = (
    "d674074d481d76d7ac4e4ae4fe5df93a458a3b6fcb483ac92190babc52029694")
# tests/test_golden.py: SA and LCP digests, and the JAX package's route
# label for each fixture (device_build_closure, pinned on the CPU by
# tests/test_torch_doubling.py).
GOLDEN_DEVICE = {
    "AP009048_10000": (
        "335641df720e6a760955d891723fa48fc1554248ac89a44b1a3f4a36eaa0fdc3",
        "427e0d914a5e7c62d4b06e9b360ced03da1889f4c3fc488169e3faf83d29be57",
        "ladder(4w)"),
    "AP009048_100000": (
        GOLDEN_SA_100K,
        "10992fb21e4db240c0024acd3661b1a3af997c0fb7a1591352a89e3e1aba373d",
        "adaptive(3b x 30ch)"),
}
# The JAX package's route labels of the generated texts below (pinned on
# the CPU by tests/test_torch_doubling.py).
LABEL_DNA = "adaptive(3b x 40ch)"  # random DNA, 4 and 64 MiB
LABEL_DNA_REPEATS = "adaptive(3b x 40ch)"
LABEL_TEXT_REPEATS = "adaptive(5b x 24ch)+2phase"
LABEL_NEARREP = "patched(q=100001,defects=32)"
LABEL_TEXT_128M = "adaptive(7b x 24ch)+2phase"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SEED = 0xD4A
N_TEXT = 1 << 22
N_TEXT_64M = 1 << 26  # the size scripts/scale_probe.py measured
N_TEXT_128M = 1 << 27  # bench.py's large text row
# The default build's shape in the benchmark's single-card cells: 200 MiB
# of text staged into 2^28 int32 slots, the rest PAD.
N_TEXT_MAIN, N_PAD_MAIN = 200 << 20, 1 << 28
N_QUERIES = 262144
QLEN = 14
LCP_SAMPLES = 1 << 16
HYBRID_SINGLES = 4096  # single queries of each method on the host route
HYBRID_DEVICE_SINGLES = 1024  # and on the device route
SMALL_BUILDS = 20000  # small native builds a length and a round
SMALL_BUILD_LENS = (11, 64, 1024)
SMALL_BUILD_REPS = 5
SAIS_COUNTERS = ("l_rounds", "s_rounds", "substring_rounds")
PROBE_SHAPE = (1 << 15, 128)  # scripts/round3_study.py section_bw: 2^22 int32
# torch.profiler scopes of ops/sais.py::_derive_sa and
# ops/prefix_doubling.py
SAIS_SCOPES = ("S1_classify_buckets", "S2_L_phase_round", "S3_S_phase_round")
DOUBLING_SCOPES = ("P0_dense_pack", "P1_initial_sort", "P2_initial_rank",
                   "P3_shift_ranks", "P4_round_sort", "P5_dense_rerank",
                   "P6_route_home", "T1_to_positional", "T2_phase2_round",
                   "T3_final_sa", "PP_small_key")
LCP_SCOPES = ("L1_base_compact", "L2_packed_stage", "L3_rows_stage",
              "L4_finish")
# bench.py's mixed battery on the 128 MiB text: pattern lengths and their
# shares, seed 0xBEEF.
BATTERY_LENS = (4, 8, 14, 24, 40)
BATTERY_P = (.25, .25, .25, .15, .10)
BATTERY_SIZES = (16384, 131072)
# serve_128m_deep: client threads, and each client's count requests (256
# patterns each) and positions requests (16 patterns each).
SERVE_CLIENTS = 16
SERVE_COUNT_REQS = 32
SERVE_POS_REQS = 8
# `stree banana`: the JAX package's dot string (pinned on the CPU by
# tests/test_torch_tree.py::test_dot_of_banana_is_pinned).
BANANA_DOT = "\n".join([
    "digraph tree {",
    'label=<<FONT POINT-SIZE="20">banana</FONT>>;',
    'labelloc="t";', 'labeljust="l";',
    '0 [label=""]', '1 [label="6", shape=box]', '0 -> 1 [label="$"]',
    '2 [label=""]', '3 [label="5", shape=box]', '2 -> 3 [label="$"]',
    '0 -> 2 [label="a"];', '4 [label=""]', '5 [label="3", shape=box]',
    '4 -> 5 [label="$"]', '2 -> 4 [label="na"];',
    '6 [label="1", shape=box]', '4 -> 6 [label="na$"];',
    '7 [label="0", shape=box]', '0 -> 7 [label="banana$"];',
    '8 [label=""]', '9 [label="4", shape=box]', '8 -> 9 [label="$"]',
    '0 -> 8 [label="na"];', '10 [label="2", shape=box]',
    '8 -> 10 [label="na$"];', "}", ""])


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def occurrences(raw: bytes, q: bytes) -> list[int]:
    """Every offset of ``q`` in ``raw``, overlaps included, ascending: the
    starts of ``re.finditer(b"(?=" + re.escape(q) + b")", raw)``, by
    ``bytes.find``."""
    out, p = [], raw.find(q)
    while p >= 0:
        out.append(p)
        p = raw.find(q, p + 1)
    return out


def overlapping_count(raw: bytes, q: bytes) -> int:
    """The number of ``occurrences``."""
    return len(occurrences(raw, q))


def dna_text(rng: np.random.Generator) -> bytes:
    """The 4 MiB random DNA text of the JAX package's bench (bench.py)."""
    return (rng.integers(0, 4, size=N_TEXT, dtype=np.uint8) + 97).tobytes()


def planted(rng: np.random.Generator, sigma: int, copies: int,
            min_len: int, max_len: int) -> bytes:
    """N_TEXT random bytes over ``sigma`` letters from ``a``, with
    ``copies`` planted repeats of [min_len, max_len) bytes: ties that
    survive the initial sort, so the doubling rounds run."""
    t = rng.integers(0, sigma, size=N_TEXT, dtype=np.uint8) + 97
    for _ in range(copies):
        m = int(rng.integers(min_len, max_len))
        src, dst = rng.integers(0, N_TEXT - m, size=2)
        t[dst:dst + m] = t[src:src + m]
    return t.tobytes()


def dna_repeats() -> bytes:
    """Random DNA with 64 planted 2 KiB copies: the classic adaptive
    route with quadrupling rounds at full width."""
    return planted(np.random.default_rng(SEED + 5), 4, 64, 2048, 2049)


def text_repeats() -> bytes:
    """Random lowercase (sigma 26) with 256 planted copies of 24-1023
    bytes: the two-phase route, its tie mass under n/8 after the first
    sort."""
    return planted(np.random.default_rng(SEED + 6), 26, 256, 24, 1024)


def nearrep_text() -> bytes:
    """bench.py's near-repeated corpus: the 100 KB E. coli fixture tiled
    45 times, cut to 2^22 bytes, then 16 positions from seed 1 XOR 1."""
    rep = np.frombuffer((FIXTURE.read_bytes() * 45)[:N_TEXT], np.uint8).copy()
    rep[np.random.default_rng(1).integers(0, 1 << 22, 16)] ^= 1
    return rep.tobytes()


def check_histogram(torch, kernels, sais, raw: bytes,
                    ptxas: list[dict]) -> dict:
    """Phase 3: byte_histogram against byte_histogram_plain on the card,
    exact, on every case; one device operation a call (torch.profiler);
    the build log's report, CTAs an SM and waves; the histogram battery.
    ``ptxas`` is the build log's report of csrc/histogram.cu."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    dev = torch.device("cuda")
    rng = np.random.default_rng(0xC0FFEE)

    def ints(lo, hi, n):
        return torch.from_numpy(rng.integers(lo, hi, size=n,
                                             dtype=np.int32)).to(dev)

    # Less than one vector (1, 3), one vector and a scalar (4, 5), a few
    # vectors and a tail (17), then ragged and whole tiles.
    cases = [(f"uniform_n{n}", ints(0, 258, n), 258)
             for n in (1, 3, 4, 5, 17, 100, 1024, 3 * 1024, 4 * 1024 - 7)]
    cases += [(f"out_of_range_bins{nb}", ints(-5, 300, 2048), nb)
              for nb in (258, 512)]
    cases.append(("empty", ints(0, 1, 0), 258))
    # Misaligned views: a scalar head of 3 and 1 values before the first
    # 16-byte boundary, at 2^22 and at less than one vector.
    big = ints(-5, 520, (1 << 22) + 3)
    small = ints(0, 258, 8)
    for off in (1, 3):
        cases += [(f"view{off}_4M", big[off:], 512),
                  (f"view{off}_n{8 - off}", small[off:], 258),
                  (f"view{off}_n1", small[off:off + 1], 258)]
    text = torch.from_numpy(np.frombuffer(raw, np.uint8).astype(np.int32))
    text = text.to(dev)
    is_s, _ = sais.classify_types(text)
    sym = (text + 1).to(torch.int32)
    cases += [("text_sym_4MiB", sym, 258),
              ("text_s_sym_4MiB", torch.where(is_s, sym, -1), 258)]
    inputs = kernels.histogram_inputs(device=dev)
    cases += [(name, v, nb) for name, (v, nb) in inputs.items()]

    max_err = 0

    def check(name, got, x, nb):
        nonlocal max_err
        want = kernels.byte_histogram_plain(x, nb)
        torch.cuda.synchronize()
        if got.shape != (nb,) or got.dtype != torch.int32:
            raise AssertionError(f"byte_histogram on {name}: shape "
                                 f"{tuple(got.shape)}, {got.dtype}")
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err != 0:
            raise AssertionError(f"byte_histogram differs from its plain "
                                 f"version on {name}: max |err| {err}")

    for name, x, nb in cases:
        check(name, kernels.byte_histogram(x, nb), x, nb)
    # Calls in a row on one stream, no sync between: each finds the
    # accumulator the last one left at rest (512 bins, then 258).
    v512, v258 = inputs["bins512"][0], inputs["dna_s_sym"][0]
    row = [kernels.byte_histogram(v512, 512), kernels.byte_histogram(v258, 258),
           kernels.byte_histogram(v258, 258)]
    for k, (got, x, nb) in enumerate(zip(row, (v512, v258, v258),
                                         (512, 258, 258))):
        check(f"in_a_row_{k}", got, x, nb)
    # Two streams at once, each with its own accumulator.
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    pairs = ((inputs["one_bin"][0], 258), (v512, 512))
    for s in streams:
        s.wait_stream(torch.cuda.current_stream())
    outs = []
    for _ in range(4):
        for s, (x, nb) in zip(streams, pairs):
            with torch.cuda.stream(s):
                outs.append((kernels.byte_histogram(x, nb), x, nb))
    torch.cuda.synchronize()
    for k, (got, x, nb) in enumerate(outs):
        check(f"two_streams_{k}", got, x, nb)

    # One device operation a call: the kernel, no memset.
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        kernels.byte_histogram(v258, 258)
        torch.cuda.synchronize()
    device_ops = [e.name for e in prof.events()
                  if e.device_type == DeviceType.CUDA]
    if len(device_ops) != 1 or "byte_histogram" not in device_ops[0]:
        raise AssertionError(f"byte_histogram ran {device_ops} on the "
                             f"device; expected its kernel alone")

    sms, ctas = kernels.histogram_occupancy(dev)
    plan = kernels.histogram_plan(v258.data_ptr(), v258.numel(), sms, ctas)
    occupancy = {"threads": kernels.HIST_THREADS, "ctas_per_sm": ctas,
                 "sms": sms, "plan": plan._asdict(),
                 "waves": plan.grid / (ctas * sms)}
    battery = kernels.histogram_battery(dev)
    emit("kernels", cases=[c[0] for c in cases], max_abs_err=max_err,
         device_ops_per_call=device_ops, ptxas=ptxas, occupancy=occupancy,
         battery=battery)
    r = next(r for r in battery if r["input"] == "dna_s_sym")
    return {"max_abs_err": max_err, "bound_by": r["bound_by"],
            **{k: r[k] for k in (
                "ms", "plain_ms", "library_ms", "bound_ms", "warm_ms",
                "read_flush_ms", "library_read_flush_ms", "bincount_ms",
                "torch_sum1_ms", "torch_sum1_read_flush_ms", "input")},
            "library_call": "torch.histc", "device_ops_per_call": 1}


def check_histogram_main_path(torch, kernels, pd) -> dict:
    """Phase 3, kernels_main_path: byte_histogram at the default build's
    shape, 256 bins over 200 MiB of bytes (all 256 values) staged as a
    build stages them (``_stage_text``: 2^28 int32 slots, 58,720,256 of
    them PAD): equal to its plain version and, through
    ``_device_byte_counts``, to ``np.bincount``; then CUDA-event medians
    of the kernel (20 calls), its plain version (3) and ``torch.bincount``
    of the text's int32 values (5)."""
    dev = torch.device("cuda")
    n, n_pad = N_TEXT_MAIN, N_PAD_MAIN
    arr = np.random.default_rng(SEED + 28).integers(0, 256, n,
                                                     dtype=np.uint8)
    padded = pd._stage_text(arr, n_pad, dev)
    got = kernels.byte_histogram(padded, 256)
    want = kernels.byte_histogram_plain(padded, 256)
    err = int((got.long() - want.long()).abs().max())
    if err != 0:
        raise AssertionError(f"byte_histogram differs from its plain version "
                             f"at 2^28 padded slots: max |err| {err}")
    if not np.array_equal(pd._device_byte_counts(padded),
                          np.bincount(arr, minlength=256)):
        raise AssertionError("the device byte counts of 200 MiB differ from "
                             "np.bincount")

    def event_ms(fn, reps):
        fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)

    text = padded[:n]
    row = {"ms": event_ms(lambda: kernels.byte_histogram(padded, 256), 20),
           "plain_ms": event_ms(
               lambda: kernels.byte_histogram_plain(padded, 256), 3),
           "bincount_ms": event_ms(
               lambda: torch.bincount(text, minlength=256), 5),
           "bound_ms": (4 * n_pad + 4 * 256) / HBM_BYTES_PER_S * 1e3}
    emit("kernels_main_path", n=n, n_pad=n_pad, n_bins=256, max_abs_err=err,
         counts_equal_bincount=True, **row)
    del padded, got, want, text
    torch.cuda.empty_cache()
    return {"max_abs_err": err, **row}


def check_probes(torch, probes, ptxas: list[dict]) -> dict:
    """Phase 3, probes: each probe kernel against its plain version, then
    the bandwidth battery with the probes' counters from 0. ``ptxas`` is
    the build log's report of csrc/probes.cu."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(3)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def make(shape):
        vals = rng.integers(0, 1 << 22, size=shape, dtype=np.int32)
        return torch.from_numpy(vals).to(dev)

    def err(got, want):
        torch.cuda.synchronize()
        if got.shape != want.shape:
            raise AssertionError(f"shape {tuple(got.shape)} != "
                                 f"{tuple(want.shape)}")
        return int((got.long() - want.long()).abs().max()) if got.numel() else 0

    errs = {"copy_blocks": 0, "copy5_blocks": 0, "minmax_stages": 0}
    cases = []
    # The study's shape, then ragged lengths: the scalar tail, less than
    # one 32 KiB chunk, no multiple of it (with and without a full grid).
    chunk = probes.COPY_CHUNK_INTS
    for shape in (PROBE_SHAPE, (1,), (5,), (4099,), (chunk - 1,),
                  (3 * chunk + 4099,), (266 * chunk + 77,)):
        xs = [make(shape) for _ in range(5)]
        errs["copy_blocks"] = max(errs["copy_blocks"], err(
            probes.copy_blocks(xs[0]), probes.copy_blocks_plain(xs[0])))
        got, want = probes.copy5_blocks(*xs), probes.copy5_blocks_plain(*xs)
        errs["copy5_blocks"] = max(errs["copy5_blocks"], *(
            err(g, w) for g, w in zip(got, want)))
        n = int(np.prod(shape))
        cases.append({"copy": shape, "plan_1": probes.copy_plan(n, 1, sms),
                      "plan_5": probes.copy_plan(n, 5, sms)})
    # (shape, stages, block_rows): the register path at the study's 16
    # blocks, at 2 (lane 0 takes the roll's wrap from lane 31) and at one
    # 16-column slab; the shared path at the full block with another
    # stage count and with a width of no whole slabs, shifts past the
    # block, and a width that is no multiple of its 8-column slab.
    for shape, stages, block_rows in ((PROBE_SHAPE, 16, 2048),
                                      ((4096, 128), 16, 2048),
                                      ((2048, 16), 16, 2048),
                                      ((4096, 128), 15, 2048),
                                      ((4096, 24), 16, 2048),
                                      ((64, 128), 16, 8),
                                      ((4096, 20), 5, 1024)):
        x = make(shape)
        errs["minmax_stages"] = max(errs["minmax_stages"], err(
            probes.minmax_stages(x, stages, block_rows),
            probes.minmax_stages_plain(x, stages, block_rows)))
        cases.append({"minmax": shape, "stages": stages,
                      "block_rows": block_rows,
                      "path": probes.minmax_path(shape[1], block_rows,
                                                 stages)})
    if any(errs.values()):
        raise AssertionError(f"a probe kernel differs from its plain "
                             f"version: {errs}")
    waves = probes.battery_waves(dev)

    # ---- the probes' path: counters from 0, the battery, counters read --
    wrappers = (probes.copy_blocks, probes.copy5_blocks, probes.minmax_stages)
    for fn in wrappers:
        fn.launches = 0
    probes.minmax_stages.path_launches = dict.fromkeys(probes.MINMAX_PATHS, 0)
    rows = probes.bandwidth_battery(dev)
    launches = {fn.__name__: fn.launches for fn in wrappers}
    paths = dict(probes.minmax_stages.path_launches)
    if not all(launches.values()) or not paths["registers"]:
        raise AssertionError(f"a probe kernel never launched in the "
                             f"battery: {launches}, minmax paths {paths}")
    emit("probes", cases=cases, max_abs_err=errs, launches=launches,
         minmax_path_launches=paths, ptxas=ptxas, waves=waves, battery=rows)
    by_op = {r["op"]: r for r in rows}
    return {name: {"max_abs_err": errs[name], "launches": launches[name],
                   **by_op[op]}
            for name, op in (("copy_blocks", "cuda_copy1"),
                             ("copy5_blocks", "cuda_copy5"),
                             ("minmax_stages", "cuda_minmax_x16"))}


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(
        np.ascontiguousarray(a, dtype=np.uint32).tobytes()).hexdigest()


def sais_build(sais, SuffixTable, raw: bytes):
    """``SuffixTable.new(raw, engine="sais", collect_stats=True)`` and the
    SA-IS pipeline's round counters, which the stats schema leaves out as
    the JAX package's does: a wrapper keeps the stats dict that
    utils/metrics.py hands the pipeline."""
    fn = sais.suffix_array_sais_recursive
    seen: dict = {}

    def wrapper(*a, stats=None, **k):
        out = fn(*a, stats=stats, **k)
        seen.update(stats or {})
        return out

    sais.suffix_array_sais_recursive = wrapper
    try:
        st = SuffixTable.new(raw, engine="sais", collect_stats=True)
    finally:
        sais.suffix_array_sais_recursive = fn
    if not seen:
        raise AssertionError("the SA-IS build did not go through "
                             "ops/sais.py::suffix_array_sais_recursive")
    return st, {k: seen.get(k, 0) for k in SAIS_COUNTERS}


def check_golden_device(SuffixTable) -> None:
    """Phase 4, golden_device: the default build of both fixtures against
    the golden SA and LCP digests and the JAX route labels."""
    for name, (sa_digest, lcp_digest, label) in GOLDEN_DEVICE.items():
        data = (ROOT / "tests" / "fixtures" / f"{name}.fasta").read_bytes()
        t0 = time.perf_counter()
        st = SuffixTable.new(data, collect_stats=True)
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lcp = st.lcp_lens()
        lcp_s = time.perf_counter() - t0
        if sha(st.table()) != sa_digest:
            raise AssertionError(f"{name}: SA differs from the golden digest")
        if sha(lcp) != lcp_digest:
            raise AssertionError(f"{name}: LCP differs from the golden digest")
        if st.build_stats["engine"] != label:
            raise AssertionError(f"{name}: route {st.build_stats['engine']!r}"
                                 f" != the JAX package's {label!r}")
        emit("golden_device", fixture=name, build_s=build_s, lcp_s=lcp_s,
             **st.build_stats)


def check_pair_lcps(raw: bytes, table: np.ndarray, ranks: np.ndarray,
                    lcp: np.ndarray) -> None:
    """For each r of ``ranks``, the suffixes at ranks r-1 and r share
    exactly ``lcp[r]`` leading bytes: the first lcp[r] are equal (libc
    ``memcmp`` in place: a near-repeated text's million-byte LCPs check in
    well under a millisecond each) and the next byte differs or one suffix
    ends."""
    t = np.frombuffer(raw, np.uint8)
    n = t.size
    memcmp = ctypes.CDLL(None).memcmp
    memcmp.argtypes = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t)
    memcmp.restype = ctypes.c_int
    base = t.ctypes.data
    for r in ranks.tolist():
        a, b, m = int(table[r - 1]), int(table[r]), int(lcp[r])
        if (a + m > n or b + m > n or memcmp(base + a, base + b, m) != 0
                or (a + m < n and b + m < n and t[a + m] == t[b + m])):
            raise AssertionError(f"LCP of ranks {r - 1}, {r} is not {m}")


def check_lcp_sample(raw: bytes, table: np.ndarray, lcp: np.ndarray) -> int:
    """LCP of LCP_SAMPLES random adjacent rank pairs against the bytes on
    the host; returns the max LCP."""
    n = len(raw)
    if lcp.shape != (n,) or lcp.dtype != np.uint32 or lcp[0] != 0:
        raise AssertionError("LCP array has the wrong shape, type or head")
    ranks = np.random.default_rng(SEED + 3).integers(1, n, size=LCP_SAMPLES)
    check_pair_lcps(raw, table, ranks, lcp)
    return int(lcp.max())


def counted_lcp(lcp_ops, native, st, trace: list | None = None):
    """(lcp, seconds, calls): ``st.lcp_lens()`` with wrappers counting the
    bulk ladder (its per-stage trace into ``trace``), the Kasai route, and
    which Kasai answered it: the native library or the numpy loop."""
    calls = {"bulk": 0, "kasai": 0, "native_kasai": 0, "numpy_kasai": 0}
    saved = {(lcp_ops, "_lcp_bulk"): lcp_ops._lcp_bulk,
             (lcp_ops, "_kasai_route"): lcp_ops._kasai_route,
             (lcp_ops, "kasai_host"): lcp_ops.kasai_host,
             (native, "kasai"): native.kasai}

    def counted(key, fn, **extra):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **extra, **k)
        return wrapper

    lcp_ops._lcp_bulk = counted("bulk", lcp_ops._lcp_bulk, trace=trace)
    lcp_ops._kasai_route = counted("kasai", lcp_ops._kasai_route)
    lcp_ops.kasai_host = counted("numpy_kasai", lcp_ops.kasai_host)
    native.kasai = counted("native_kasai", native.kasai)
    try:
        t0 = time.perf_counter()
        lcp = st.lcp_lens()
        lcp_s = time.perf_counter() - t0
    finally:
        for (mod, name), fn in saved.items():
            setattr(mod, name, fn)
    return lcp, lcp_s, calls


def check_lcp_64m(torch, lcp_ops, native, st, raw: bytes) -> str:
    """lcp_64m: ``lcp_lens()`` through the bulk ladder (wrappers count the
    ladder and Kasai calls and take the ladder's per-stage trace); the
    census in (2048, n/64]; sampled pairs and every survivor pair against
    the bytes. Returns the LCP array's digest."""
    t_phase = time.perf_counter()
    trace: list = []
    torch.cuda.reset_peak_memory_stats()
    lcp, lcp_s, calls = counted_lcp(lcp_ops, native, st, trace)
    peak = torch.cuda.max_memory_allocated()
    n = len(raw)
    if calls["bulk"] != 1 or calls["kasai"] != 0:
        raise AssertionError(f"lcp_64m took {calls}; expected the bulk "
                             "ladder once and no Kasai")
    census = trace[0]["survivors"]
    if not lcp_ops.LCP_SURV_CHUNKED < census <= n // 64:
        raise AssertionError(f"survivor census {census} outside "
                             f"({lcp_ops.LCP_SURV_CHUNKED}, {n // 64}]")
    t0 = time.perf_counter()
    max_lcp = check_lcp_sample(raw, st.table(), lcp)
    deep = np.flatnonzero(lcp >= 18)
    if deep.size != census:
        raise AssertionError(f"{deep.size} pairs with LCP >= 18, census "
                             f"{census}")
    check_pair_lcps(raw, st.table(), deep, lcp)
    emit("lcp_64m", lcp_s=lcp_s, census=census,
         survivor_pairs_checked=int(deep.size), sampled_pairs=LCP_SAMPLES,
         max_lcp=max_lcp, check_s=time.perf_counter() - t0,
         peak_device_gib=peak / 2**30, ladder=trace,
         phase_s=time.perf_counter() - t_phase)
    return sha(lcp)


# byte_histogram's launches in each default build of build_device, by
# phase: the kernel table's callers on the main path.
MAIN_PATH_LAUNCHES: dict[str, int] = {}


def build_device(torch, kernels, SuffixTable, verify, raw: bytes, phase: str,
                 label: str = LABEL_DNA, histograms: int = 1, **extra):
    """A default build with stats, its route label and certificate;
    byte_histogram's counter set to 0 just before the build and read just
    after, ``histograms`` launches expected (one count of the text's
    bytes; the patched route's rotation build counts its own);
    ``extra`` goes into the phase's line."""
    torch.cuda.reset_peak_memory_stats()
    kernels.byte_histogram.launches = 0
    t0 = time.perf_counter()
    st = SuffixTable.new(raw, collect_stats=True)
    build_s = time.perf_counter() - t0
    launches = kernels.byte_histogram.launches
    peak = torch.cuda.max_memory_allocated()
    if st.build_stats["engine"] != label:
        raise AssertionError(f"route {st.build_stats['engine']!r} != the "
                             f"JAX package's {label!r}")
    if launches != histograms:
        raise AssertionError(f"{phase}: byte_histogram launched {launches} "
                             f"times; expected {histograms}")
    MAIN_PATH_LAUNCHES[phase] = launches
    t0 = time.perf_counter()
    if not verify(raw, st.table()):
        raise AssertionError(f"{phase}: table fails the certificate")
    emit(phase, build_s=build_s, certificate_s=time.perf_counter() - t0,
         peak_device_gib=peak / 2**30, histogram_launches=launches, **extra,
         **st.build_stats)
    return st


def profile(torch, label: str, fn, scope_names=SAIS_SCOPES) -> None:
    """Device busy share and top kernels of one call of ``fn``, from
    ``torch.profiler``; the scopes in ``scope_names`` are reported with
    their host and device spans, and every scan kernel by name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    scopes = {}
    for e in events:
        if e.key in scope_names:
            side = "device_ms" if e.device_type == DeviceType.CUDA else "host_ms"
            entry = scopes.setdefault(e.key, {"calls": e.count})
            total = (e.device_time_total if side == "device_ms"
                     else e.cpu_time_total)
            entry[side] = total / 1e3
    kernels = [e for e in events
               if e.device_type == DeviceType.CUDA and e.key not in scopes]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    top = sorted(kernels, key=lambda e: e.self_device_time_total,
                 reverse=True)[:12]
    emit(f"profile_{label}", wall_s=wall,
         device_busy_s=busy_ms / 1e3 if busy_ms else None,
         idle_share=1 - busy_ms / 1e3 / wall if busy_ms else None,
         scopes=scopes,
         top_kernels=[{"name": e.key[:100], "calls": e.count,
                       "device_ms": e.self_device_time_total / 1e3}
                      for e in top],
         scan_kernels=[{"name": e.key[:160], "calls": e.count,
                        "device_ms": e.self_device_time_total / 1e3}
                       for e in kernels if "scan" in e.key.lower()])


def check_queries(st, raw: bytes, rng: np.random.Generator,
                  phase: str = "queries") -> list[bytes]:
    """Phase 6: one batch of every query kind through the table."""
    n = len(raw)

    def drawn(k: int, m: int) -> list[bytes]:
        return [raw[s:s + m] for s in rng.integers(0, n - m, size=k)]

    kinds = {
        "drawn14": drawn(N_QUERIES, QLEN),
        "random14": [bytes(r) for r in
                     (rng.integers(0, 4, size=(4096, QLEN), dtype=np.uint8)
                      + 97)],
        "drawn24": drawn(256, 24),
        "drawn48": drawn(256, 48),
        "empty": [b""],
    }
    queries = [q for qs in kinds.values() for q in qs]
    t0 = time.perf_counter()
    counts = st.count_batch(queries)
    first_s = time.perf_counter() - t0
    positions = st.positions_batch(queries)

    for q, c, pos in zip(queries, counts, positions):
        if len(pos) != c:
            raise AssertionError(f"positions/count mismatch for {q!r}")
        for p in pos.tolist():
            if raw[p:p + len(q)] != q:
                raise AssertionError(f"offset {p} does not match {q!r}")
    if counts[-1] != 0:
        raise AssertionError("the empty query must match nothing")
    sample_rng = np.random.default_rng(SEED + 1)
    base = 0
    checked = 0
    for name, qs in kinds.items():
        if name != "empty":
            pick = sample_rng.choice(len(qs), size=min(256, len(qs)),
                                     replace=False)
            for i in pick.tolist():
                want = overlapping_count(raw, qs[i])
                if counts[base + i] != want:
                    raise AssertionError(
                        f"{name} query {qs[i]!r}: count {counts[base + i]} "
                        f"!= {want} on the raw bytes")
                checked += 1
        base += len(qs)

    drawn14 = kinds["drawn14"]
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        st.count_batch(drawn14)
        times.append(time.perf_counter() - t0)
    batch_s = statistics.median(times)
    emit(phase, n_queries=len(queries), first_batch_s=first_s,
         sampled_checks=checked, matches=int(counts.sum()),
         absent_random14=int((counts[N_QUERIES:N_QUERIES + 4096] == 0).sum()),
         batch_262144x14_s=batch_s, batch_times_s=times,
         queries_per_s=N_QUERIES / batch_s)
    return drawn14


def battery_128m(txt: np.ndarray) -> dict[str, list[bytes]]:
    """The 128 MiB query kinds: bench.py's mixed battery at each of
    BATTERY_SIZES (seed 0xBEEF, starts in [0, n - 64)), 1,024 drawn 64-byte
    patterns and 1,024 random lowercase ones of 4-40 bytes."""
    n = txt.size
    rng = np.random.default_rng(0xBEEF)
    kinds = {}
    for nq in BATTERY_SIZES:
        lens = rng.choice(BATTERY_LENS, size=nq, p=BATTERY_P)
        starts = rng.integers(0, n - 64, size=nq)
        kinds[f"mixed{nq}"] = [txt[s:s + m].tobytes()
                               for s, m in zip(starts, lens)]
    rng = np.random.default_rng(SEED + 128)
    kinds["drawn64"] = [txt[s:s + 64].tobytes()
                        for s in rng.integers(0, n - 64, size=1024)]
    kinds["random"] = [bytes(rng.integers(97, 123, size=int(m),
                                          dtype=np.uint8))
                       for m in rng.integers(4, 41, size=1024)]
    return kinds


def flat_bounds(torch, search2, st, fences, block,
                queries: list[bytes]) -> tuple[np.ndarray, np.ndarray]:
    """(start, count) of the flat-key merge engine on ``st``'s device
    text and table, the queries packed as ``SuffixTable._bounds_batch``
    packs them."""
    from suffix_torch.ops.padding import PAD, bucket_size
    from suffix_torch.ops.search import pack_queries

    q, qlens = pack_queries(queries)
    m_pad = bucket_size(q.shape[1], minimum=8)
    full = np.full((q.shape[0], m_pad), PAD, np.int32)
    full[:, :q.shape[1]] = q
    n = len(st)
    starts, counts = search2.bounds_batch_merge(
        st._dev_text, n, st._dev_table, n, fences, block,
        torch.from_numpy(full).to(st.device),
        torch.from_numpy(qlens).to(st.device), m_pad)
    return (starts.cpu().numpy().astype(np.int64),
            counts.cpu().numpy().astype(np.int64))


def check_bounds(raw: bytes, table: np.ndarray, queries: list[bytes],
                 starts: np.ndarray, counts: np.ndarray, k: int) -> int:
    """On ``k`` sampled queries: the suffixes at start and start+count-1
    begin with the pattern, the one at start-1 sorts below it and the one
    at start+count above it (prefix comparison). On a certified table this
    proves the bounds. Returns the number checked."""
    n = len(raw)
    pick = np.random.default_rng(SEED + 129).choice(len(queries), size=k,
                                                    replace=False)
    for i in pick.tolist():
        q, s, c = queries[i], int(starts[i]), int(counts[i])

        def head(r):
            p = int(table[r])
            return raw[p:p + len(q)]

        if c and (head(s) != q or head(s + c - 1) != q):
            raise AssertionError(f"{q!r}: a bound suffix does not match")
        if s > 0 and not head(s - 1) < q:
            raise AssertionError(f"{q!r}: the suffix before start does "
                                 "not sort below the pattern")
        if s + c < n and not head(s + c) > q:
            raise AssertionError(f"{q!r}: the suffix after the range does "
                                 "not sort above the pattern")
    return k


def check_deep_queries(torch, search2, st, raw: bytes) -> dict:
    """queries_128m_deep: the deep keyless index, the battery through the
    public batch calls, every bound equal to the flat-key engine's, 4,096
    checked on the bytes; queries per second, median of 5. Returns each
    kind's (queries, starts, counts)."""
    t_phase = time.perf_counter()
    n = len(raw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st._ensure_device()
    torch.cuda.synchronize()
    index_s = time.perf_counter() - t0
    index_peak = torch.cuda.max_memory_allocated()
    if st._pk is not None or st._ext_block is None:
        raise AssertionError("the 128 MiB index is not the deep keyless one")
    kinds = battery_128m(np.frombuffer(raw, np.uint8))
    t0 = time.perf_counter()
    _, fences, block = search2.build_query_index(
        st._dev_text, st._dev_table, n, key_words=search2.EXT_KEY_WORDS)
    torch.cuda.synchronize()
    flat_index_s = time.perf_counter() - t0
    everything = [[], [], []]
    rows, bounds = {}, {}
    for name, qs in kinds.items():
        t0 = time.perf_counter()
        counts = st.count_batch(qs)
        first_s = time.perf_counter() - t0
        starts, counts_b = st._bounds_batch(qs)
        want_s, want_c = flat_bounds(torch, search2, st, fences, block, qs)
        if not (np.array_equal(counts, counts_b)
                and np.array_equal(counts_b, want_c)
                and np.array_equal(starts, want_s)):
            raise AssertionError(f"{name}: deep keyless bounds differ from "
                                 "the flat-key engine's")
        rows[name] = {"queries": len(qs), "first_batch_s": first_s,
                      "matched": int((counts > 0).sum())}
        bounds[name] = (qs, starts, counts)
        for acc, part in zip(everything, (qs, starts, counts)):
            acc.extend(part)
    del fences, block
    checked = check_bounds(raw, st.table(), *everything, k=4096)
    for nq in BATTERY_SIZES:
        qs = kinds[f"mixed{nq}"]
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            st.count_batch(qs)
            times.append(time.perf_counter() - t0)
        rows[f"mixed{nq}"].update(batch_times_s=times,
                                  queries_per_s=nq / statistics.median(times))
    emit("queries_128m_deep", index_s=index_s,
         index_peak_device_gib=index_peak / 2**30,
         flat_index_s=flat_index_s, bounds_checked=checked, kinds=rows,
         phase_s=time.perf_counter() - t_phase)
    return bounds


def check_lean(torch, search2, st) -> None:
    """lean_128m: the lean keyless build against the one-program
    with_keys=False build, bit for bit, with each one's peak memory over
    what was resident before it."""
    t_phase = time.perf_counter()
    n = len(st)

    def build(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (out, time.perf_counter() - t0,
                (torch.cuda.max_memory_allocated() - base) / 2**30,
                base / 2**30)

    one, one_s, one_gib, one_base = build(lambda: search2.build_query_index(
        st._dev_text, st._dev_table, n, with_keys=False))
    stride = one[2].shape[1] // search2.KEY_WORDS
    lean, lean_s, lean_gib, lean_base = build(
        lambda: search2._build_query_index_lean(
            st._dev_text, st._dev_table, n, search2.KEY_WORDS, stride))
    if not (torch.equal(one[2], lean[2])
            and all(torch.equal(a, b) for a, b in zip(one[1], lean[1]))):
        raise AssertionError("the lean build differs from the one-program "
                             "build")
    emit("lean_128m", stride=stride, one_program_s=one_s,
         one_program_peak_over_resident_gib=one_gib,
         resident_before_one_gib=one_base, lean_s=lean_s,
         lean_peak_over_resident_gib=lean_gib,
         resident_before_lean_gib=lean_base,
         phase_s=time.perf_counter() - t_phase)


def check_native(native, SuffixTable, card: str) -> None:
    """native: build the C++ library and the CPython extension from
    ``suffix_torch/native/csrc`` (both must load: no silent fallback), then
    the golden SA and LCP digests of both fixtures through
    ``engine="native"`` and ``lcp_lens("native")``."""
    lib, ext = native.library_path(), native.extension_path()
    fresh = {"library": not lib.exists(), "extension": not ext.exists()}
    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError(f"the native library did not build: "
                             f"{native._load_error}")
    lib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    if native._load_fastpath() is None:
        raise AssertionError(f"the _fastpath extension did not load: "
                             f"{native.fastpath_error}")
    ext_s = time.perf_counter() - t0
    build_dir = ROOT / "suffix_torch" / "_build"
    if lib.parent != build_dir or ext.parent != build_dir:
        raise AssertionError(f"native builds outside {build_dir}")
    fixtures = []
    for name, (sa_digest, lcp_digest, _) in GOLDEN_DEVICE.items():
        data = (ROOT / "tests" / "fixtures" / f"{name}.fasta").read_bytes()
        t0 = time.perf_counter()
        st = SuffixTable.new(data, engine="native")
        build_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        lcp = st.lcp_lens("native")
        lcp_s = time.perf_counter() - t0
        if sha(st.table()) != sa_digest or sha(lcp) != lcp_digest:
            raise AssertionError(f"{name}: the native SA or LCP differs from "
                                 "the golden digest")
        fixtures.append({"fixture": name, "build_s": build_s, "lcp_s": lcp_s})
    emit("native", card=card, library=lib.name, extension=ext.name,
         built_in_this_run=fresh, library_build_s=lib_s,
         extension_build_s=ext_s, flags=list(native.CXX_FLAGS),
         extension_loaded=True, fixtures=fixtures)


def check_small_builds(native, SuffixTable, resolve_device,
                       card: str) -> None:
    """build_small_native: mean µs of one small native build, over
    SMALL_BUILDS random texts of each length in SMALL_BUILD_LENS, through
    the fast path (``new(engine="native")``, which skips ``__init__``) and
    through ``__init__`` (``SuffixTable(t, native.sais(t))``), beside the C
    SA-IS alone and ``resolve_device(None)`` alone; the median of
    SMALL_BUILD_REPS rounds, the four in turn; the two tables equal."""
    rng = np.random.default_rng(SEED + 11)
    sais_c = native._load_fastpath().sais

    def fast(texts):
        for t in texts:
            SuffixTable.new(t, engine="native")

    def plain(texts):
        for t in texts:
            SuffixTable(t, native.sais(t))

    def c_only(texts):
        for t in texts:
            sais_c(t)

    def resolve(texts):
        for _ in texts:
            resolve_device(None)

    cases = {"fast_path": fast, "init": plain, "c_sais": c_only,
             "resolve_device": resolve}
    rows = []
    for m in SMALL_BUILD_LENS:
        texts = [bytes(r) for r in rng.integers(97, 101, size=(SMALL_BUILDS,
                                                               m),
                                                dtype=np.uint8)]
        for t in texts[:64]:
            if SuffixTable.new(t, engine="native") != SuffixTable(
                    t, native.sais(t)):
                raise AssertionError(f"fast-path table differs at {m} bytes")
        us = {k: [] for k in cases}
        for _ in range(SMALL_BUILD_REPS):
            for k, fn in cases.items():
                t0 = time.perf_counter()
                fn(texts)
                us[k].append((time.perf_counter() - t0) / len(texts) * 1e6)
        rows.append({"len": m, **{f"{k}_us": statistics.median(v)
                                  for k, v in us.items()}})
    emit("build_small_native", card=card, builds=SMALL_BUILDS,
         reps=SMALL_BUILD_REPS, rows=rows)


def check_lcp_kasai(lcp_ops, native, st, raw: bytes, phase: str,
                    card: str) -> str:
    """lcp_4m_nearrep, lcp_128m_text: ``lcp_lens()`` on a survivor-dense
    table: the sampler sends it to Kasai (wrappers: Kasai once, by the
    native library; the bulk ladder never), 65,536 sampled pairs checked
    against the bytes. Returns the LCP array's digest."""
    lcp, lcp_s, calls = counted_lcp(lcp_ops, native, st)
    if calls != {"bulk": 0, "kasai": 1, "native_kasai": 1, "numpy_kasai": 0}:
        raise AssertionError(f"{phase} took {calls}; expected the native "
                             "Kasai once and no bulk ladder")
    t0 = time.perf_counter()
    max_lcp = check_lcp_sample(raw, st.table(), lcp)
    emit(phase, card=card, n=len(raw), lcp_s=lcp_s, calls=calls,
         route="native_kasai", sampled_pairs=LCP_SAMPLES, max_lcp=max_lcp,
         check_s=time.perf_counter() - t0)
    return sha(lcp)


def hybrid_queries(raw: bytes) -> list[bytes]:
    """HYBRID_SINGLES queries over the 4 MiB DNA text, shuffled: drawn
    14-byte patterns, absent 14-byte ones (letters the text lacks), drawn
    64-byte patterns and the empty query."""
    n = len(raw)
    rng = np.random.default_rng(SEED + 7)
    k = HYBRID_SINGLES // 4
    qs = [raw[s:s + QLEN] for s in rng.integers(0, n - QLEN, size=2 * k)]
    qs += [bytes(r) for r in rng.integers(101, 123, size=(k, QLEN),
                                          dtype=np.uint8)]
    qs += [raw[s:s + 64] for s in rng.integers(0, n - 64, size=k - 1)]
    qs.append(b"")
    return [qs[i] for i in rng.permutation(len(qs))]


def check_hybrid(native, search2, st, raw: bytes, card: str) -> None:
    """queries_hybrid: the four single-query methods of a CUDA table under
    ``query_route="auto"`` (the host route, the extension's methods bound
    onto the table) and ``"device"``, every answer equal; a batch of
    HOST_QUERY_MAX on the host and one more on the device, by wrappers;
    the median microseconds a call of each."""
    t_phase = time.perf_counter()
    queries = hybrid_queries(raw)
    ops = ("positions", "contains", "count", "any_position")

    def run(qs):
        out, us = {}, {}
        for op in ops:
            res, times = [], []
            for q in qs:
                t0 = time.perf_counter_ns()
                r = getattr(st, op)(q)
                times.append(time.perf_counter_ns() - t0)
                res.append(r)
            out[op], us[op] = res, statistics.median(times) / 1e3
        return out, us

    st.query_route = "auto"
    host, host_us = run(queries)
    bound = sorted(op for op in ops if op in st.__dict__)
    if bound != sorted(ops) or st._host_handle is None:
        raise AssertionError(f"the host route did not bind the extension's "
                             f"methods: {bound}")
    st.query_route = "device"
    dev_qs = queries[:HYBRID_DEVICE_SINGLES]
    dev, dev_us = run(dev_qs)
    for op in ops:
        for q, a, b in zip(dev_qs, host[op], dev[op]):
            same = (np.array_equal(a, b) and a.dtype == b.dtype
                    if op == "positions" else a == b and type(a) is type(b))
            if not same:
                raise AssertionError(f"{op}({q!r}): host {a!r} != device "
                                     f"{b!r}")
    for q, c, pos in zip(queries, host["count"], host["positions"]):
        if c != len(pos):
            raise AssertionError(f"count/positions mismatch for {q!r}")
    checked = 0
    for q, c in list(zip(queries, host["count"]))[:256]:
        if c != (overlapping_count(raw, q) if q else 0):
            raise AssertionError(f"count({q!r}) = {c} on the host route")
        checked += 1
    # Batches: HOST_QUERY_MAX on the host, one more on the device.
    st.query_route = "auto"
    calls = {"host_batch": 0, "device_batch": 0}
    saved = (native.bounds_batch, search2.bounds_batch_merge,
             search2.bounds_batch_merge_deep)

    def counted(key, fn):
        def wrapper(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapper

    native.bounds_batch = counted("host_batch", saved[0])
    search2.bounds_batch_merge = counted("device_batch", saved[1])
    search2.bounds_batch_merge_deep = counted("device_batch", saved[2])
    try:
        m = st.HOST_QUERY_MAX
        small = st.count_batch(queries[:m])
        after_small = dict(calls)
        big = st.count_batch(queries[:m + 1])
    finally:
        (native.bounds_batch, search2.bounds_batch_merge,
         search2.bounds_batch_merge_deep) = saved
    if (after_small != {"host_batch": 1, "device_batch": 0}
            or calls != {"host_batch": 1, "device_batch": 1}):
        raise AssertionError(f"batch routing: {after_small} after {m}, "
                             f"{calls} after {m + 1}; expected the host "
                             "then the device")
    if not (np.array_equal(small, host["count"][:m])
            and np.array_equal(big, host["count"][:m + 1])):
        raise AssertionError("batch counts differ from the single queries")
    handle = st._host_handle
    drawn = raw[1000:1000 + QLEN]  # a present 14-byte pattern
    emit("queries_hybrid", card=card, n=len(raw), host_singles=len(queries),
         device_singles=len(dev_qs), route_auto="host_ext",
         median_us={"host": host_us, "device": dev_us},
         c_only_ns={"bounds_drawn14": handle.bench_c_only(drawn),
                    "contains_drawn14": handle.bench_c_only(
                        drawn, op="contains")},
         batch_routing={m: "host", m + 1: "device"},
         sampled_count_checks=checked, phase_s=time.perf_counter() - t_phase)


def check_verify_device(SuffixTable, tables, card: str) -> None:
    """verify_device: ``verify(device=True)`` against the host certificate
    on each (name, raw, table) of ``tables`` and on the first one with two
    adjacent entries swapped (both must say False); seconds of each."""
    rows = []
    name0, raw0, tab0 = tables[0]
    bad = tab0.copy()
    bad[[1000, 1001]] = bad[[1001, 1000]]
    for name, raw, tab, want in [(n, r, t, True) for n, r, t in tables] + [
            (f"{name0}_swapped", raw0, bad, False)]:
        st = SuffixTable.from_parts(raw, tab)
        t0 = time.perf_counter()
        dev = st.verify(device=True)
        dev_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = st.verify()
        host_s = time.perf_counter() - t0
        if dev is not want or host is not want:
            raise AssertionError(f"{name}: device {dev}, host {host}; "
                                 f"expected {want}")
        rows.append({"table": name, "n": len(raw), "result": want,
                     "device_s": dev_s, "host_s": host_s})
    emit("verify_device", card=card, rows=rows)


class CountedTable:
    """A table whose ``_bounds_batch`` records each dispatch's query
    count; every other attribute is the wrapped table's. Given to a
    ``Batcher`` it counts the queries of each drained batch; given to
    ``serve_tcp`` without one, each request's."""

    def __init__(self, st):
        self._st = st
        self.sizes: list[int] = []

    def __getattr__(self, name):
        return getattr(self._st, name)

    def _bounds_batch(self, queries):
        self.sizes.append(len(queries))
        return self._st._bounds_batch(queries)


def serve_requests(kinds: dict[str, list[bytes]]) -> list[list[tuple]]:
    """Each client's requests: 32 ``count`` requests of 256 patterns of
    the 131,072 mixed battery, and after every fourth one a ``positions``
    request of 16 drawn 64-byte or random patterns. Returns, per client,
    (op, patterns, JSON line) in sending order."""
    counts = kinds["mixed131072"]
    pos = kinds["drawn64"] + kinds["random"]
    out = []
    for c in range(SERVE_CLIENTS):
        reqs = []
        for j in range(SERVE_COUNT_REQS):
            k = c * SERVE_COUNT_REQS + j
            reqs.append(("count", counts[k * 256:(k + 1) * 256]))
            if j % 4 == 3:
                m = c * SERVE_POS_REQS + j // 4
                reqs.append(("positions", pos[m * 16:(m + 1) * 16]))
        out.append([(op, qs, json.dumps({
            "id": i, "op": op,
            "q_b64": [base64.b64encode(q).decode() for q in qs]}) + "\n")
            for i, (op, qs) in enumerate(reqs)])
    return out


def serve_load(serve, st, requests: list[list[tuple]], batcher) -> dict:
    """One ``serve_tcp`` on 127.0.0.1, port 0, over ``st`` with
    ``batcher`` (or none); a client thread each, each sending its
    requests one at a time on one connection. Returns the answers and
    each request's seconds (send to answer), per client, and the wall
    seconds from the common start to the last answer."""
    import socket

    ready = threading.Event()
    server = threading.Thread(target=serve.serve_tcp, args=(st, 0),
                              kwargs={"batcher": batcher,
                                      "ready_event": ready}, daemon=True)
    server.start()
    if not ready.wait(timeout=60):
        raise AssertionError("serve_tcp did not start")
    addr = ready.server.server_address
    gate = threading.Barrier(len(requests) + 1)
    answers = [None] * len(requests)
    latency = [None] * len(requests)
    errors = []

    def client(c):
        try:
            with socket.create_connection(addr, timeout=300) as conn:
                f = conn.makefile("rb")
                got, secs = [], []
                gate.wait(timeout=60)
                for _, _, line in requests[c]:
                    t0 = time.perf_counter()
                    conn.sendall(line.encode())
                    got.append(json.loads(f.readline()))
                    secs.append(time.perf_counter() - t0)
                answers[c], latency[c] = got, secs
        except Exception as e:  # reported below, after the join
            errors.append(e)
            gate.abort()

    threads = [threading.Thread(target=client, args=(c,))
               for c in range(len(requests))]
    try:
        for t in threads:
            t.start()
        gate.wait(timeout=60)
        t0 = time.perf_counter()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
    finally:
        ready.server.shutdown()
        server.join(timeout=60)
    if errors or any(t.is_alive() for t in threads) or server.is_alive():
        raise AssertionError(f"serving run failed: {errors}")
    return {"answers": answers, "latency": latency, "wall": wall}


def check_serve(torch, serve, st, raw: bytes, card: str) -> None:
    """serve_128m_deep: the serving runtime over the 128 MiB deep keyless
    index, 16 clients over TCP, with a Batcher(max_batch=131072,
    max_wait_ms=2) and without one; every answer equal to the table's
    own batch calls on the same patterns."""
    t_phase = time.perf_counter()
    kinds = battery_128m(np.frombuffer(raw, np.uint8))
    requests = serve_requests(kinds)
    count_qs = [q for reqs in requests for op, qs, _ in reqs
                if op == "count" for q in qs]
    pos_qs = [q for reqs in requests for op, qs, _ in reqs
              if op == "positions" for q in qs]
    want_count = dict(zip(count_qs, st.count_batch(count_qs).tolist()))
    want_pos = {q: sorted(h.tolist())
                for q, h in zip(pos_qs, st.positions_batch(pos_qs))}
    rows = {}
    for mode in ("batcher", "no_batcher"):
        counted = CountedTable(st)
        batcher = None
        if mode == "batcher":
            batcher = serve.Batcher(counted, max_batch=131072,
                                    max_wait_ms=2.0)
        try:
            run = serve_load(serve, st if batcher else counted, requests,
                             batcher)
        finally:
            if batcher is not None:
                batcher.close()
        for reqs, got in zip(requests, run["answers"]):
            for (op, qs, _), ans in zip(reqs, got):
                if op == "count":
                    ok = ans["result"] == [want_count[q] for q in qs]
                else:
                    ok = [sorted(r) for r in ans["result"]] == [
                        want_pos[q] for q in qs]
                if not ok:
                    raise AssertionError(f"{mode}: a {op} answer differs "
                                         f"from the table's: {ans}")
        lat = np.array([x for secs in run["latency"] for x in secs])
        n_req = int(lat.size)
        n_q = len(count_qs) + len(pos_qs)
        rows[mode] = {
            "requests": n_req, "queries": n_q, "wall_s": run["wall"],
            "requests_per_s": n_req / run["wall"],
            "queries_per_s": n_q / run["wall"],
            "p50_ms": float(np.percentile(lat, 50)) * 1e3,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3,
            "max_ms": float(lat.max()) * 1e3,
            "dispatches": len(counted.sizes),
            "mean_queries_per_dispatch": float(np.mean(counted.sizes)),
            "max_queries_per_dispatch": int(max(counted.sizes)),
        }
    # One caller, no server: a request's batch and a full drain's, so the
    # served times split into the batch itself and what serving adds.
    alone = {}
    for k in (256, 4096):
        times = []
        for _ in range(9):
            t0 = time.perf_counter()
            st.count_batch(count_qs[:k])
            times.append(time.perf_counter() - t0)
        alone[f"batch_{k}_ms"] = statistics.median(times) * 1e3
    emit("serve_128m_deep", card=card, clients=SERVE_CLIENTS,
         count_requests=SERVE_CLIENTS * SERVE_COUNT_REQS,
         positions_requests=SERVE_CLIENTS * SERVE_POS_REQS,
         positions_hits=sum(len(v) for v in want_pos.values()), **rows,
         alone=alone, phase_s=time.perf_counter() - t_phase)


def check_tree_invariants(tree, sa: np.ndarray, spot: int = 2000) -> None:
    """The reference's three tree invariants (suffix_tree/src/lib.rs:
    507-567) on the arrays, as tests/test_atree.py:90-124 states them:
    every rank is a leaf child or a node terminal and leaves() counts the
    bytes; every internal node has two children, or one and a terminal;
    preorder suffix indices enumerate the SA (the first ``spot``); and
    path depth grows down every edge."""
    n = tree.n
    n_term = int(tree.is_term.sum())
    if n_term != int((tree.node_term >= 0).sum()):
        raise AssertionError("terminal ranks and node terminals differ")
    leaf_like = (n - n_term) + int(
        ((tree.node_term >= 0) & (tree.node_end > tree.node_start)).sum())
    if leaf_like != n:
        raise AssertionError(f"{leaf_like} leaves for {n} bytes")
    e_parent = tree._ensure_edges()[0]
    counts = np.bincount(e_parent[e_parent >= 0].astype(np.int64),
                         minlength=tree.m)
    if not np.all((counts >= 2) | ((tree.node_term >= 0) & (counts >= 1))):
        raise AssertionError("an internal node has too few children")
    for i, sufi in enumerate(tree.root().suffix_indices()):
        if sufi != int(sa[i]):
            raise AssertionError(f"preorder suffix {i} is not the SA's")
        if i >= spot:
            break
    pd = np.where(tree.node_parent >= 0,
                  tree.node_d[np.maximum(tree.node_parent, 0)], 0)
    if not np.all(tree.node_d > pd):
        raise AssertionError("a node is no deeper than its parent")


TREE_ARRAYS = ("node_l", "node_d", "node_r", "node_parent", "node_start",
               "node_end", "node_term", "leaf_parent", "leaf_start",
               "is_term")


def check_trees(torch, SuffixTable, tables, dev, card: str) -> None:
    """tree_4m: ArraySuffixTree over the 4 MiB DNA and near-repeated
    tables (LCP and device program), seconds, nodes and peak; the three
    invariants on each; the card's arrays equal to the same program on the
    CPU over the 100 KB fixture; the dot string equal to the host fold's
    over the 10 KB fixture."""
    from suffix_torch import ArraySuffixTree, SuffixTree
    from suffix_torch.tree import to_dot

    t_phase = time.perf_counter()
    rows = {}
    for name, st in tables:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        tree = ArraySuffixTree.from_suffix_table(st)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        t0 = time.perf_counter()
        check_tree_invariants(tree, st.table())
        rows[name] = {"n": tree.n, "m": tree.m, "seconds": secs,
                      "max_depth": int(tree.node_d.max(initial=0)),
                      "peak_device_gib": peak / 2**30,
                      "peak_over_resident_gib": (peak - base) / 2**30,
                      "invariants_s": time.perf_counter() - t0}
        del tree
    fixture = FIXTURE.read_bytes()
    on_card = ArraySuffixTree.from_suffix_table(
        SuffixTable.new(fixture, engine="auto", device=dev))
    on_cpu = ArraySuffixTree.from_suffix_table(
        SuffixTable.new(fixture, engine="auto", device="cpu"))
    if on_card.m != on_cpu.m or not all(
            np.array_equal(getattr(on_card, k), getattr(on_cpu, k))
            for k in TREE_ARRAYS):
        raise AssertionError("the 100 KB tree's arrays differ between the "
                             "card and the CPU")
    small = SuffixTable.new(FIXTURE_10K.read_bytes(), device=dev)
    dot = to_dot(ArraySuffixTree.from_suffix_table(small))
    if dot != to_dot(SuffixTree.from_suffix_table(small)):
        raise AssertionError("the 10 KB array tree's dot differs from the "
                             "host fold's")
    emit("tree_4m", card=card, trees=rows, fixture_100k_m=on_card.m,
         dot_10k_bytes=len(dot), phase_s=time.perf_counter() - t_phase)


def check_cli(raw: bytes, max_lcp: int, card: str, table_sha: str,
              platform: str = "cuda") -> None:
    """cli: ``python -m suffix_torch`` in subprocesses on the 4 MiB DNA
    text in a temporary directory (build with stats and -o, the sharded
    build over one rank with a checkpoint, stree banana and warmup at
    once; then search, search --sharded --devices 1, info and serve
    --tcp 0 --batch --warm at once), each output checked (the sharded
    search's stdout equal to the plain one's), the sharded build's saved
    table against ``table_sha``; each step's wall seconds."""
    import queue
    import socket
    import tempfile

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 70)
    patterns = [raw[s:s + 14] for s in rng.integers(0, len(raw) - 14, 48)]
    patterns += [bytes(rng.integers(101, 123, size=8, dtype=np.uint8))
                 for _ in range(16)]
    queries = [q.decode() for q in patterns]
    steps = {}

    def popen(*args):
        cmd = [sys.executable, "-m", "suffix_torch", "--platform", platform,
               *args]
        return subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

    def start(name, *args):
        """A step in its own process, its output collected by a thread
        that stamps the step's wall seconds when the process ends."""
        t0 = time.perf_counter()
        proc = popen(*args)
        done = {}

        def collect():
            try:
                done["out"], done["err"] = proc.communicate(timeout=600)
            except subprocess.TimeoutExpired:
                proc.kill()
                done["out"], done["err"] = proc.communicate()
            steps[name] = time.perf_counter() - t0

        t = threading.Thread(target=collect, daemon=True)
        t.start()
        return name, proc, t, done

    def finish(job) -> str:
        name, proc, t, done = job
        t.join(timeout=700)
        if t.is_alive() or proc.returncode != 0:
            raise AssertionError(f"cli {name} exited {proc.returncode}: "
                                 f"{done.get('err', '')[-2000:]}")
        return done["out"]

    with tempfile.TemporaryDirectory() as tmp:
        text, idx = Path(tmp) / "dna.txt", Path(tmp) / "idx.npz"
        text.write_bytes(raw)
        idx_sh, ck = Path(tmp) / "sharded.npz", Path(tmp) / "ck.npz"
        jobs = [start("build", "build", str(text), "-o", str(idx), "--stats"),
                start("build_sharded", "build", str(text), "--engine",
                      "sharded", "--devices", "1", "--checkpoint", str(ck),
                      "--stats", "-o", str(idx_sh)),
                start("stree", "stree", "banana"),
                start("warmup", "warmup", "--size", str(len(raw)),
                      "--batches", "4096", "--qlens", "16")]
        build, build_sh, stree, warmup = (finish(j) for j in jobs)
        with np.load(idx_sh) as z:
            sharded_ok = sha(z["table"]) == table_sha
        with np.load(ck) as z:
            ck_round = (int(z["k"]), bool(z["done"]))
        if build_sh != f"Suffixes: {len(raw)}\n" or not sharded_ok:
            raise AssertionError(f"cli build --engine sharded printed "
                                 f"{build_sh[:300]!r}; table equal: "
                                 f"{sharded_ok}")
        lines = build.splitlines()
        stats = json.loads(lines[1])
        if lines[0] != f"Suffixes: {len(raw)}" or stats["engine"] != \
                "native-sais":
            raise AssertionError(f"cli build printed {build[:300]!r}")
        if stree != BANANA_DOT:
            raise AssertionError("cli stree banana differs from JAX's dot")
        warmed = [ln.strip() for ln in warmup.splitlines()]
        if not warmed[-1].startswith("warmed ") or len(warmed) < 5:
            raise AssertionError(f"cli warmup printed {warmup!r}")

        t_serve = time.perf_counter()
        proc = popen("serve", "--index", str(idx), "--tcp", "0", "--batch",
                     "--max-batch", "4096", "--warm")
        jobs = [start("search", "search", "--index", str(idx), *queries),
                start("search_sharded", "search", "--sharded", "--devices",
                      "1", "--index", str(idx), *queries),
                start("info", "info", str(idx))]
        try:
            lines_q = queue.Queue()

            def pump():
                for ln in proc.stderr:
                    lines_q.put(ln)
                lines_q.put(None)  # the server exited

            threading.Thread(target=pump, daemon=True).start()
            stderr = []
            while True:
                line = lines_q.get(timeout=600)
                if line is None:
                    raise AssertionError("cli serve exited before serving: "
                                         f"{''.join(stderr)[-2000:]}")
                stderr.append(line)
                if line.startswith("serving on "):
                    break
            ready_s = time.perf_counter() - t_serve
            host, port = line.split()[-1].rsplit(":", 1)
            count_q = patterns[:8]
            with socket.create_connection((host, int(port)),
                                          timeout=120) as conn:
                f = conn.makefile("rw", encoding="utf-8")
                for req in ({"id": 1, "op": "ping"},
                            {"id": 2, "op": "count",
                             "q": [q.decode() for q in count_q]},
                            {"id": 3, "op": "quit"}):
                    f.write(json.dumps(req) + "\n")
                f.flush()
                answers = [json.loads(x) for x in f]
            serve_s = time.perf_counter() - t_serve
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=60)
        want = [{"id": 1, "result": "pong"},
                {"id": 2, "result": [overlapping_count(raw, q)
                                     for q in count_q]},
                {"id": 3, "result": "bye"}]
        if answers != want:
            raise AssertionError(f"cli serve answered {answers}")
        search, search_sharded, info = (finish(j) for j in jobs)
    if search_sharded != search:
        raise AssertionError("cli search --sharded printed "
                             f"{search_sharded[:300]!r}, search "
                             f"{search[:300]!r}")
    got = [ln.split("\t") for ln in search.splitlines()]
    for q, (name, count, pos) in zip(patterns, got):
        hits = occurrences(raw, q)
        if name != q.decode() or int(count) != len(hits) or pos != ",".join(
                map(str, hits)):
            raise AssertionError(f"cli search {q!r}: {count} hits")
    if len(got) != len(patterns):
        raise AssertionError(f"cli search printed {len(got)} lines")
    if f"max lcp:      {max_lcp}" not in info.splitlines():
        raise AssertionError(f"cli info printed {info!r}")
    emit("cli", card=card, step_s=steps, sharded_checkpoint_k_done=ck_round,
         serve_ready_s=ready_s,
         serve_s=serve_s,
         serve_warm_lines=[ln.strip() for ln in stderr[:-1]],
         warmup=warmed, build_stats=stats,
         matched=sum(int(c) > 0 for _, c, _ in got),
         phase_s=time.perf_counter() - t_phase)


# ---- the probe-chain engines, hybrid SA-IS, the sharded build ----

def sync_peak(torch, dev, reset: bool = False):
    """Wait for ``dev``; the peak device memory in GiB since the last
    reset (None off the card), or reset it."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    if reset:
        torch.cuda.reset_peak_memory_stats(dev)
        return None
    return torch.cuda.max_memory_allocated(dev) / 2**30


def timed(torch, dev, fn, reps: int = 5):
    """(result of a first call, seconds of each of ``reps`` more calls),
    every call ended by a synchronise."""
    out = fn()
    sync_peak(torch, dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        sync_peak(torch, dev)
        times.append(time.perf_counter() - t0)
    return out, times


def check_search_probe(torch, search, search2, st, queries: list[bytes],
                       card: str) -> None:
    """search_probe: the probe-chain engines, ``bounds_batch`` (windowed
    binary search) and ``bounds_batch_fast`` (``probe_lut``, probe chains
    over the first two key words, byte refine past 6 bytes), on the
    default 4 MiB table's 262,144-query battery, every count and every
    live start equal to the flat merge-join engine's; median seconds of 5
    calls and queries/s of each engine, the merge-join's beside them, on
    the same packed queries on the card."""
    from suffix_torch.ops.padding import PAD, bucket_size

    t_phase = time.perf_counter()
    st._ensure_device()
    dev, n = st.device, len(st)
    q, qlens = search.pack_queries(queries)
    m_pad = bucket_size(q.shape[1], minimum=8)
    full = np.full((q.shape[0], m_pad), PAD, np.int32)
    full[:, :q.shape[1]] = q
    qd = torch.from_numpy(full).to(dev)
    ld = torch.from_numpy(qlens).to(dev)
    n_iters = (st._dev_text.shape[0] + 1).bit_length()
    pk = st._pk
    lut, lut_times = timed(torch, dev, lambda: search2.probe_lut(pk[0], n))
    engines = {
        "merge": lambda: search2.bounds_batch_merge(
            st._dev_text, n, st._dev_table, n, st._pk_fence, st._pk_block,
            qd, ld, m_pad),
        "bounds_batch": lambda: search.bounds_batch(
            st._dev_text, n, st._dev_table, n, qd, ld, n_iters),
        "bounds_batch_fast": lambda: search2.bounds_batch_fast(
            st._dev_text, n, st._dev_table, n, pk[0], pk[1], lut, qd, ld,
            n_iters, m_pad),
    }
    got, rows = {}, {}
    for name, fn in engines.items():
        out, times = timed(torch, dev, fn)
        got[name] = [x.cpu().numpy() for x in out]
        med = statistics.median(times)
        rows[name] = {"median_s": med, "queries_per_s": len(queries) / med,
                      "times_s": times}
    m_start, m_count = got["merge"]
    live = m_count > 0
    for name in ("bounds_batch", "bounds_batch_fast"):
        start, count = got[name]
        if not np.array_equal(count, m_count) or not np.array_equal(
                start[live], m_start[live]):
            raise AssertionError(f"{name} differs from the merge-join "
                                 "bounds")
    emit("search_probe", card=card, n=n, n_queries=len(queries),
         m_pad=m_pad, n_iters=n_iters, live=int(live.sum()),
         lut_median_s=statistics.median(lut_times), engines=rows,
         phase_s=time.perf_counter() - t_phase)


def check_sais_hybrid(sais, raw: bytes, want_sha: str, card: str) -> None:
    """sais_hybrid: ``suffix_array_sais`` (LMS ranks from the doubling
    engine, then the induced derivation) on the 4 MiB DNA text; its
    table's digest equal to the default build's."""
    t0 = time.perf_counter()
    sa = sais.suffix_array_sais(raw)
    build_s = time.perf_counter() - t0
    if sha(sa) != want_sha:
        raise AssertionError("the hybrid SA-IS table differs from the "
                             "default build's")
    emit("sais_hybrid", card=card, n=len(raw), build_s=build_s,
         sha=want_sha)


def check_collective_bins(torch, kernels, collective_bins, mesh,
                          raw: bytes, card: str) -> int:
    """collective_bins: ``global_bucket_layout`` over the one-rank mesh on
    the 64 MiB DNA text, its counts, heads and tails equal to a
    ``torch.bincount`` of the symbols on the card; the byte_histogram
    counter, set to 0 just before the call, read just after (one launch
    on the card). Then the resident block's layout (``bins_shard``:
    kernel, all-reduce, cumsum) beside the plain histogram and
    ``bincount``, medians of 5. Returns the launches of the call."""
    t_phase = time.perf_counter()
    dev = mesh.device
    text = np.frombuffer(raw, np.uint8).astype(np.int32)
    kernels.byte_histogram.launches = 0
    t0 = time.perf_counter()
    counts, heads, tails = collective_bins.global_bucket_layout(text, mesh)
    layout_s = time.perf_counter() - t0
    launches = kernels.byte_histogram.launches
    if launches != (1 if dev.type == "cuda" else 0):
        raise AssertionError(f"global_bucket_layout launched byte_histogram "
                             f"{launches} times")
    block = torch.from_numpy(text).to(dev)
    sym = block + 1
    want = torch.bincount(sym, minlength=collective_bins.N_SYM)
    want = want.to(torch.int32).cpu().numpy()
    want_tails = np.cumsum(want, dtype=np.int32)
    for got, ref in ((counts, want), (heads, want_tails - want),
                     (tails, want_tails)):
        if got.dtype != np.int32 or not np.array_equal(got, ref):
            raise AssertionError("the collective bucket layout differs from "
                                 "torch.bincount")
    rows = {}
    for name, fn in (
            ("bins_shard", lambda: collective_bins.bins_shard(block, mesh)),
            ("plain_histogram", lambda: kernels.byte_histogram_plain(
                sym, collective_bins.N_SYM)),
            ("bincount", lambda: torch.bincount(
                sym, minlength=collective_bins.N_SYM))):
        rows[name] = statistics.median(timed(torch, dev, fn)[1])
    emit("collective_bins", card=card, n=len(raw), world=mesh.world_size,
         launches=launches, layout_s=layout_s, device_median_s=rows,
         symbols_present=int((counts > 0).sum()),
         phase_s=time.perf_counter() - t_phase)
    return launches


def check_sharded_build(torch, dist_build, mesh, texts, card: str) -> None:
    """sharded_build: on the one-rank mesh, ``suffix_array_sharded`` (the
    single-device closure) on the first text, and
    ``suffix_array_sharded_stepped`` (the SPMD round body) on each of
    ``texts`` = [(name, raw, want_sha)], every table's digest equal to the
    default build's; seconds, rounds and peak memory."""
    t_phase = time.perf_counter()
    dev = mesh.device
    runs = []

    def one(name: str, route: str, fn, want_sha: str):
        rounds = []
        sync_peak(torch, dev, reset=True)
        resident = (torch.cuda.memory_allocated(dev) / 2**30
                    if dev.type == "cuda" else None)
        t0 = time.perf_counter()
        sa = fn(rounds)
        secs = time.perf_counter() - t0
        peak = sync_peak(torch, dev)
        if sha(sa) != want_sha:
            raise AssertionError(f"sharded_build {name} ({route}) differs "
                                 "from the default build")
        runs.append({"text": name, "route": route, "seconds": secs,
                     "rounds": len(rounds) if route == "stepped" else None,
                     "k": [k for k, _ in rounds], "peak_device_gib": peak,
                     "resident_gib": resident})

    name, raw, want = texts[0]
    one(name, "one-shot", lambda _: dist_build.suffix_array_sharded(raw, mesh),
        want)
    for name, raw, want in texts:
        one(name, "stepped", lambda r, raw=raw: (
            dist_build.suffix_array_sharded_stepped(
                raw, mesh, round_hook=lambda k, d: r.append((k, d)))), want)
    emit("sharded_build", card=card, world=mesh.world_size, runs=runs,
         phase_s=time.perf_counter() - t_phase)


class StopBuild(Exception):
    """Raised by a round hook to stop a stepped build between rounds."""


def check_sharded_ckpt(dist_build, mesh, raw: bytes, want_sha: str,
                       card: str, stop_after: int = 3) -> None:
    """sharded_ckpt: the stepped build of the 4 MiB near-repeated corpus,
    checkpointed every round; a second run whose hook raises after round
    ``stop_after``, then a resume from its checkpoint: the same table as
    the uninterrupted run (and the default build), the remaining rounds
    only."""
    import tempfile

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        full = []
        t0 = time.perf_counter()
        sa = dist_build.suffix_array_sharded_stepped(
            raw, mesh, checkpoint_path=str(Path(tmp) / "full.npz"),
            round_hook=lambda k, d: full.append((k, d)))
        full_s = time.perf_counter() - t0
        if sha(sa) != want_sha:
            raise AssertionError("sharded_ckpt: the stepped table differs "
                                 "from the default build's")
        ck = str(Path(tmp) / "cut.npz")
        seen = []

        def stop(k, done):
            seen.append(k)
            if len(seen) == stop_after:
                raise StopBuild

        try:
            dist_build.suffix_array_sharded_stepped(
                raw, mesh, checkpoint_path=ck, round_hook=stop)
            raise AssertionError("sharded_ckpt: the build ran past the hook")
        except StopBuild:
            pass
        with np.load(ck) as z:
            cut_k = int(z["k"])
        rest = []
        t0 = time.perf_counter()
        sa2 = dist_build.suffix_array_sharded_stepped(
            raw, mesh, checkpoint_path=ck, resume=True,
            round_hook=lambda k, d: rest.append((k, d)))
        resume_s = time.perf_counter() - t0
    if not np.array_equal(sa2, sa) or rest != full[stop_after:]:
        raise AssertionError(f"sharded_ckpt: resumed from k={cut_k}, rounds "
                             f"{rest} != {full[stop_after:]}")
    emit("sharded_ckpt", card=card, n=len(raw), rounds=len(full),
         k=[k for k, _ in full], stopped_at_k=cut_k, full_s=full_s,
         resume_s=resume_s, resumed_rounds=len(rest),
         phase_s=time.perf_counter() - t_phase)


def frequent_byte(raw: bytes, floor: int) -> bytes:
    """The byte of ``raw`` that occurs least often above ``floor`` times:
    its slice takes more than one collective chunk of ``floor`` ranks."""
    counts = np.bincount(np.frombuffer(raw, np.uint8), minlength=256)
    above = np.flatnonzero(counts > floor)
    return bytes([int(above[np.argmin(counts[above])])])


def check_sharded_serve(torch, dist_query, SuffixTable, SuffixTree,
                        dryrun, mesh, card: str, *, text128: bytes,
                        sha_128m: str, deep: dict, tab128: np.ndarray,
                        freq: tuple, raw64: bytes, tab64: np.ndarray,
                        sha_lcp64: str, nearrep: bytes,
                        tab_near: np.ndarray, sha_lcp_near: str) -> tuple:
    """sharded_serve: ShardedQueryIndex over the one-rank NCCL mesh.

    The 128 MiB text with ``sa=None`` (the device-resident build, the
    align and the keys): seconds, peak over resident, bytes a position of
    text, table and keys, the table's digest the default build's; the
    queries_128m_deep battery, every (start, count) equal to the deep
    index's (``deep``), queries per second (median of 5); 256 patterns
    through ``positions_batch`` with no host table (one byte, ``freq``,
    past MAX_SLICE_ELEMS), each slice the single-card table's, 16 checked
    as sets on the bytes, ``any_position`` the slice's first row. The
    LCPs of the 64 MiB DNA and the 4 MiB near-repeated text equal the
    lcp_64m and lcp_4m_nearrep arrays (digests): seconds, peak, rounds,
    survivors. ``SuffixTree.from_sharded`` on the 100 KB fixture; the dry
    run at one rank. Returns the 64 MiB DNA index's (battery, starts,
    counts) for sharded_multi."""
    import gc

    t_phase = time.perf_counter()
    dev = mesh.device
    out = {}

    def start_peak():
        sync_peak(torch, dev, reset=True)
        return torch.cuda.memory_allocated(dev)

    base = start_peak()
    t0 = time.perf_counter()
    idx = dist_query.ShardedQueryIndex(text128, mesh)
    index_s = time.perf_counter() - t0
    peak = sync_peak(torch, dev)
    if idx._sa_host is not None or sha(idx.table()) != sha_128m:
        raise AssertionError("sharded_serve: the 128 MiB device-resident "
                             "index's table differs from the default build")
    out["index_128m"] = {
        "seconds": index_s, "peak_device_gib": peak,
        "peak_over_resident_gib": peak - base / 2**30,
        "resident_gib": torch.cuda.memory_allocated(dev) / 2**30,
        "bytes_per_position": idx._resident_bytes() / idx.n_pad,
        "n_pad": idx.n_pad}

    rows = {}
    for name, (qs, want_s, want_c) in deep.items():
        t0 = time.perf_counter()
        starts, counts = idx.bounds_batch(*idx._encode(qs))
        first_s = time.perf_counter() - t0
        if not (np.array_equal(starts, want_s)
                and np.array_equal(counts, want_c)):
            bad = int(np.sum((starts != want_s) | (counts != want_c)))
            raise AssertionError(f"sharded_serve {name}: {bad} bounds "
                                 "differ from the deep index's")
        rows[name] = {"queries": len(qs), "first_batch_s": first_s}
        if name.startswith("mixed"):
            times = timed(torch, dev, lambda qs=qs: idx.count_batch(qs))[1]
            rows[name].update(batch_times_s=times, queries_per_s=len(
                qs) / statistics.median(times))
    out["queries"] = rows

    pats = deep["mixed16384"][0][:255] + [freq[0]]
    want_s = np.append(deep["mixed16384"][1][:255], freq[1])
    want_c = np.append(deep["mixed16384"][2][:255], freq[2])
    t0 = time.perf_counter()
    slices = idx.positions_batch(pats)
    slices_s = time.perf_counter() - t0
    anyp = idx.any_position_batch(pats)
    for p, got, s, c, a in zip(pats, slices, want_s, want_c, anyp):
        if not np.array_equal(got, tab128[s:s + c]):
            raise AssertionError(f"sharded_serve: the slice of {p!r} "
                                 "differs from the single-card table's")
        if a != (int(got[0]) if c else None):
            raise AssertionError(f"sharded_serve: any_position({p!r})")
    sets = [i for i, c in enumerate(want_c[:255]) if c][:16]
    for i in sets:
        if sorted(slices[i].tolist()) != occurrences(text128, pats[i]):
            raise AssertionError(f"sharded_serve: {pats[i]!r} positions")
    byte = np.frombuffer(freq[0], np.uint8)[0]
    if not np.array_equal(np.sort(slices[-1]), np.flatnonzero(
            np.frombuffer(text128, np.uint8) == byte)):
        raise AssertionError(f"sharded_serve: {freq[0]!r} positions")
    out["slices"] = {"patterns": len(pats), "seconds": slices_s,
                     "frequent": freq[0].decode(), "frequent_count":
                     int(freq[2]), "max_slice_elems":
                     idx.MAX_SLICE_ELEMS, "set_checked": len(sets) + 1}
    del idx, slices
    gc.collect()

    lcps = {}
    for name, raw, tab, want in (("dna_64m", raw64, tab64, sha_lcp64),
                                 ("nearrep_4m", nearrep, tab_near,
                                  sha_lcp_near)):
        sidx = dist_query.ShardedQueryIndex(raw, mesh, sa=tab)
        base = start_peak()
        t0 = time.perf_counter()
        lcp = sidx.lcp_lens()
        secs = time.perf_counter() - t0
        peak = sync_peak(torch, dev)
        if sha(lcp) != want:
            raise AssertionError(f"sharded_serve: the {name} sharded LCP "
                                 "differs from the single-card one")
        lcps[name] = {"seconds": secs, "peak_device_gib": peak,
                      "peak_over_resident_gib": peak - base / 2**30,
                      "max_lcp": int(lcp.max()), **sidx._lcp_trace}
        if name == "dna_64m":
            battery = battery_128m(np.frombuffer(raw, np.uint8))[
                "mixed16384"]
            multi = (battery, *sidx.bounds_batch(*sidx._encode(battery)))
        del sidx, lcp
        gc.collect()
    out["lcp"] = lcps

    fixture = FIXTURE.read_bytes()
    t0 = time.perf_counter()
    tree = SuffixTree.from_sharded(dist_query.ShardedQueryIndex(fixture,
                                                                mesh))
    tree_s = time.perf_counter() - t0
    ref = SuffixTree.from_suffix_table(SuffixTable.new(fixture))
    if [n.suffixes for n in tree.root().preorder()] != [
            n.suffixes for n in ref.root().preorder()]:
        raise AssertionError("sharded_serve: SuffixTree.from_sharded "
                             "differs from from_suffix_table")
    out["tree_100k"] = {"seconds": tree_s}
    del tree, ref

    t0 = time.perf_counter()
    summary = dryrun.dryrun_multichip(1)
    if summary is None or set(summary["surfaces"].values()) != {"ok"}:
        raise AssertionError(f"sharded_serve: dryrun_multichip(1) gave "
                             f"{summary}")
    out["dryrun_1"] = {"seconds": time.perf_counter() - t0,
                       "build_s_1MB": summary["build_s_1MB"]}
    emit("sharded_serve", card=card, world=mesh.world_size, n=len(text128),
         **out, phase_s=time.perf_counter() - t_phase)
    return multi


def _multi_rank(mesh, path: str, ckpt: str, battery: list) -> dict:
    """One rank of sharded_multi: the one-shot and the stepped build of the
    text at ``path`` and its bucket layout over ``mesh``; then its
    ShardedQueryIndex (``sa=None``), the ``battery``'s bounds and the LCP;
    each timed from a barrier to this rank's result; digests, and whether
    every rank's agree; then the dry run over the mesh."""
    import torch
    import torch.distributed as dist

    from suffix_torch.ops import kernels
    from suffix_torch.parallel import collective_bins, dist_build, dryrun
    from suffix_torch.parallel.dist_query import ShardedQueryIndex
    from suffix_torch.utils.io import open_corpus

    out, rounds = {}, []
    dev = mesh.device

    def run(name: str, fn):
        dist.barrier()
        sync_peak(torch, dev)
        t0 = time.perf_counter()
        got = fn()
        sync_peak(torch, dev)
        out[f"{name}_s"] = time.perf_counter() - t0
        return got

    sync_peak(torch, dev, reset=True)
    out["one_shot"] = sha(run("one_shot", lambda: (
        dist_build.suffix_array_sharded(path, mesh))))
    out["stepped"] = sha(run("stepped", lambda: (
        dist_build.suffix_array_sharded_stepped(
            np.asarray(open_corpus(path)), mesh, checkpoint_path=ckpt,
            round_hook=lambda k, d: rounds.append(k)))))
    out["k"] = rounds
    text = np.fromfile(path, np.uint8).astype(np.int32)
    kernels.byte_histogram.launches = 0
    layout = run("layout", lambda: (
        collective_bins.global_bucket_layout(text, mesh)))
    out["launches"] = kernels.byte_histogram.launches
    out["layout"] = [a.tolist() for a in layout]
    idx = run("index", lambda: ShardedQueryIndex(path, mesh))
    out["bounds"] = [sha(a) for a in run("bounds", lambda: idx.bounds_batch(
        *idx._encode(battery)))]
    out["lcp"] = sha(run("lcp", idx.lcp_lens))
    out["lcp_trace"] = idx._lcp_trace
    del idx
    out["peak_device_gib"] = sync_peak(torch, dev)
    seen = [None] * mesh.world_size
    dist.all_gather_object(seen, (out["one_shot"], out["stepped"],
                                  out["layout"], out["launches"],
                                  out["bounds"], out["lcp"]))
    out["ranks_agree"] = all(x == seen[0] for x in seen)
    out["dryrun"] = run("dryrun", lambda: dryrun.dryrun_multichip(
        mesh.world_size, device=dev.type))
    return out


def check_sharded_multi(torch, launch, raw: bytes, want_sha: str,
                        card: str, multi: tuple, sha_lcp64: str) -> None:
    """sharded_multi: where the machine has two or more cards, worlds of 2
    and (with four cards) 4 NCCL ranks, one process a card
    (``launch.spawn``), on the 64 MiB DNA text: the one-shot and the
    stepped build, each digest the default build's, and the bucket
    layout, equal to ``np.bincount`` with one byte_histogram launch a
    rank; the ShardedQueryIndex (``sa=None``): the 16,384 battery's
    bounds equal to the one-rank index's (``multi`` = (battery, starts,
    counts)) and the LCP's digest to lcp_64m's; the dry run over the
    world; seconds of each inside the ranks and of the whole spawn. With
    one card it is not run."""
    import tempfile

    count = torch.cuda.device_count()
    if count < 2:
        emit("sharded_multi", card=card, run=False, cards=count,
             reason="one card: NCCL puts one rank on a card, so a "
                    "multi-rank exchange needs two or more")
        return
    t_phase = time.perf_counter()
    sym = np.frombuffer(raw, np.uint8).astype(np.int64) + 1
    counts = np.bincount(sym, minlength=258).astype(np.int32)
    tails = np.cumsum(counts, dtype=np.int32)
    want_layout = [counts.tolist(), (tails - counts).tolist(), tails.tolist()]
    torch.cuda.empty_cache()
    worlds = []
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "dna64.txt"
        path.write_bytes(raw)
        for world in (2, 4)[:1 + (count >= 4)]:
            t0 = time.perf_counter()
            got = launch.spawn(_multi_rank, world, str(path),
                               str(Path(tmp) / f"ck{world}.npz"), multi[0])
            spawn_s = time.perf_counter() - t0
            if (got["one_shot"] != want_sha or got["stepped"] != want_sha
                    or got["layout"] != want_layout or got["launches"] != 1
                    or got["bounds"] != [sha(a) for a in multi[1:]]
                    or got["lcp"] != sha_lcp64 or not got["ranks_agree"]
                    or got["dryrun"] is None):
                raise AssertionError(f"sharded_multi at {world} ranks: "
                                     f"tables {got['one_shot'][:12]} / "
                                     f"{got['stepped'][:12]}, launches "
                                     f"{got['launches']}, bounds "
                                     f"{got['bounds']}, lcp "
                                     f"{got['lcp'][:12]}, ranks agree "
                                     f"{got['ranks_agree']}")
            worlds.append({"world": world, "spawn_s": spawn_s,
                           **{k: v for k, v in got.items()
                              if k not in ("layout", "one_shot", "stepped",
                                           "bounds", "lcp")}})
    emit("sharded_multi", card=card, run=True, cards=count, n=len(raw),
         worlds=worlds, phase_s=time.perf_counter() - t_phase)


KERNEL_KEYS = ("launches", "max_abs_err", "ms", "plain_ms", "bound_ms",
               "bound_by", "library_ms")


def kernel_entry(name: str, source: str, replaces: str, r: dict,
                 extra: tuple[str, ...] = ()) -> dict:
    """A kernel's record of the kernel table: the keys every kernel has,
    then the ``extra`` keys of ``r``."""
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            **{k: r[k] for k in KERNEL_KEYS + tuple(extra)}}


def main() -> int:
    import gc

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from suffix_torch import SuffixTable, native
    from suffix_torch.device import resolve_device
    from suffix_torch import serve
    from suffix_torch.ops import kernels, probes, sais, search, search2
    from suffix_torch.ops import prefix_doubling as pd
    from suffix_torch.ops import lcp as lcp_ops
    from suffix_torch import SuffixTree
    from suffix_torch.parallel import (collective_bins, dist_build,
                                       dist_query, dryrun, launch)
    from suffix_torch.parallel.mesh import destroy_group, make_mesh
    from suffix_torch.utils import textgen
    from suffix_torch.utils.verify import verify_suffix_array

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    card = smi.splitlines()[0]
    print(card, flush=True)
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), nvidia_smi=card)

    t0 = time.perf_counter()
    libs = kernels.build()
    ptxas = [line.strip() for path in libs.values()
             for line in path.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "smem" in line]
    emit("build", seconds=time.perf_counter() - t0,
         libraries=[p.name for p in libs.values()], ptxas=ptxas)

    rng = np.random.default_rng(SEED)
    raw = dna_text(rng)
    hist = check_histogram(torch, kernels, sais, raw, kernels.ptxas_report(
        libs["histogram"].with_suffix(".log").read_text()))
    hist_main = check_histogram_main_path(torch, kernels, pd)
    probe = check_probes(torch, probes, kernels.ptxas_report(
        libs["probes"].with_suffix(".log").read_text()))

    fixture = FIXTURE.read_bytes()
    st100, rounds = sais_build(sais, SuffixTable, fixture)
    if sha(st100.table()) != GOLDEN_SA_100K:
        raise AssertionError("100 KB fixture SA differs from the golden digest")
    emit("golden", n=len(fixture), **st100.build_stats, **rounds)
    check_golden_device(SuffixTable)

    # ---- the SA-IS path: counters from 0, build + queries, counters read -
    kernels.byte_histogram.launches = 0
    st, rounds = sais_build(sais, SuffixTable, raw)
    build_launches = kernels.byte_histogram.launches
    if build_launches < 2:
        raise AssertionError(f"byte_histogram launched {build_launches} "
                             "times in the 4 MiB build; expected >= 2")
    t0 = time.perf_counter()
    if not verify_suffix_array(raw, st.table()):
        raise AssertionError("4 MiB table fails the suffix-array certificate")
    emit("build_4m", certificate_s=time.perf_counter() - t0,
         histogram_launches=build_launches, **st.build_stats, **rounds)
    drawn14 = check_queries(st, raw, rng)
    launches = kernels.byte_histogram.launches

    # ---- where the time goes (after the counters were read) -------------
    profile(torch, "build_4m",
            lambda: SuffixTable.new(raw, engine="sais"))
    profile(torch, "queries_262144x14", lambda: st.count_batch(drawn14))
    del st

    # ---- the main path: default build, queries, LCP ---------------------
    st_d = build_device(torch, kernels, SuffixTable, verify_suffix_array,
                        raw, "build_4m_device")
    drawn14_d = check_queries(st_d, raw, np.random.default_rng(SEED + 2),
                              phase="queries_device")
    sha_4m = sha(st_d.table())
    check_search_probe(torch, search, search2, st_d, drawn14_d, card)
    check_sais_hybrid(sais, raw, sha_4m, card)
    t0 = time.perf_counter()
    lcp = st_d.lcp_lens()
    lcp_s = time.perf_counter() - t0
    max_lcp_4m = check_lcp_sample(raw, st_d.table(), lcp)
    emit("lcp_4m", lcp_s=lcp_s, max_lcp=max_lcp_4m,
         sampled_pairs=LCP_SAMPLES)

    raw64 = (np.random.default_rng(SEED + 64).integers(
        0, 4, size=N_TEXT_64M, dtype=np.uint8) + 97).tobytes()
    st64 = build_device(torch, kernels, SuffixTable, verify_suffix_array,
                        raw64, "build_64m_device")
    sha_lcp64 = check_lcp_64m(torch, lcp_ops, native, st64, raw64)
    profile(torch, "lcp_64m", st64.lcp_lens, LCP_SCOPES)
    tab64 = st64.table()  # for verify_device
    del st64

    # The other routes of the default build at 4 MiB: rounds at full
    # width, and the two-phase engine.
    repeats = dna_repeats()
    build_device(torch, kernels, SuffixTable, verify_suffix_array, repeats,
                 "build_4m_device_repeats", LABEL_DNA_REPEATS)
    text = text_repeats()
    build_device(torch, kernels, SuffixTable, verify_suffix_array, text,
                 "build_4m_device_text", LABEL_TEXT_REPEATS)
    nearrep = nearrep_text()
    # Two counts: the text's, and the rotation build's of its first two
    # tiles (2^18 padded slots).
    st_near = build_device(torch, kernels, SuffixTable, verify_suffix_array,
                           nearrep, "build_4m_device_nearrep", LABEL_NEARREP,
                           histograms=2)

    profile(torch, "build_4m_device", lambda: SuffixTable.new(raw),
            DOUBLING_SCOPES)
    profile(torch, "build_4m_device_repeats",
            lambda: SuffixTable.new(repeats), DOUBLING_SCOPES)
    profile(torch, "build_4m_device_text", lambda: SuffixTable.new(text),
            DOUBLING_SCOPES)
    profile(torch, "build_4m_device_nearrep",
            lambda: SuffixTable.new(nearrep), DOUBLING_SCOPES)
    profile(torch, "lcp_4m", st_d.lcp_lens, ())

    # ---- 128 MiB text: build, deep keyless queries, lean build ----------
    t0 = time.perf_counter()
    text128 = textgen.text_corpus(N_TEXT_128M).tobytes()
    st128 = build_device(torch, kernels, SuffixTable, verify_suffix_array,
                         text128, "build_128m_text", LABEL_TEXT_128M,
                         generate_s=time.perf_counter() - t0)
    deep = check_deep_queries(torch, search2, st128, text128)
    check_serve(torch, serve, st128, text128, card)
    drain = battery_128m(np.frombuffer(text128, np.uint8))["mixed16384"][:4096]
    profile(torch, "queries_128m_deep_4096", lambda: st128.count_batch(drain),
            ())
    check_lean(torch, search2, st128)

    # ---- the native engine, the Kasai LCPs, the hybrid route, verify ---
    check_native(native, SuffixTable, card)
    check_small_builds(native, SuffixTable, resolve_device, card)
    t0 = time.perf_counter()
    st_n = SuffixTable.new(raw, engine="auto", collect_stats=True)
    build_s = time.perf_counter() - t0
    if st_n.build_stats["engine"] != "native-sais":
        raise AssertionError(f"engine='auto' at 4 MiB took "
                             f"{st_n.build_stats['engine']!r}")
    if not np.array_equal(st_n.table(), st_d.table()):
        raise AssertionError("the native 4 MiB table differs from the "
                             "default build's")
    emit("build_4m_native", card=card, build_s=build_s,
         mb_per_s=len(raw) / 1e6 / build_s, **st_n.build_stats)
    del st_n
    sha_lcp_near = check_lcp_kasai(lcp_ops, native, st_near, nearrep,
                                   "lcp_4m_nearrep", card)
    check_trees(torch, SuffixTable, [("dna_4m", st_d), ("nearrep_4m", st_near)],
                "cuda", card)
    tab_near = st_near.table()
    sha_near = sha(tab_near)
    del st_near
    check_lcp_kasai(lcp_ops, native, st128, text128, "lcp_128m_text", card)
    tab128 = st128.table()
    sha_128m = sha(tab128)
    # A byte whose slice takes more than one collective chunk, with its
    # bounds on the single-card index (sharded_serve).
    freq = frequent_byte(text128,
                         dist_query.ShardedQueryIndex.MAX_SLICE_ELEMS)
    freq = (freq, *(int(a[0]) for a in st128._bounds_batch([freq])))
    del st128
    check_hybrid(native, search2, st_d, raw, card)
    check_verify_device(SuffixTable, [("dna_4m", raw, st_d.table()),
                                      ("dna_64m", raw64, tab64)], card)
    del st_d
    gc.collect()  # tables freed by reference cycles leave the card now

    # ---- the sharded build: a one-rank NCCL mesh in this process --------
    mesh = make_mesh(1)
    bins_launches = check_collective_bins(torch, kernels, collective_bins,
                                          mesh, raw64, card)
    sha_64m = sha(tab64)
    check_sharded_build(torch, dist_build, mesh,
                        [("dna_64m", raw64, sha_64m),
                         ("text_128m", text128, sha_128m)], card)
    gc.collect()
    multi = check_sharded_serve(
        torch, dist_query, SuffixTable, SuffixTree, dryrun, mesh, card,
        text128=text128, sha_128m=sha_128m, deep=deep, tab128=tab128,
        freq=freq, raw64=raw64, tab64=tab64, sha_lcp64=sha_lcp64,
        nearrep=nearrep, tab_near=tab_near, sha_lcp_near=sha_lcp_near)
    del text128, tab128, tab64, tab_near, deep
    gc.collect()
    check_sharded_ckpt(dist_build, mesh, nearrep, sha_near, card)
    destroy_group()
    check_sharded_multi(torch, launch, raw64, sha_64m, card, multi,
                        sha_lcp64)
    del raw64
    check_cli(raw, max_lcp_4m, card, sha_4m)

    print(json.dumps({"kernels": [
        kernel_entry("byte_histogram", "suffix_torch/csrc/histogram.cu",
                     "suffix_tpu/ops/pallas_kernels.py:51",
                     {**hist, "launches": launches, "callers": {
                         "sais_build_4m_and_queries": launches,
                         "collective_bins_64m": bins_launches,
                         **MAIN_PATH_LAUNCHES},
                      "main_path": hist_main},
                     ("input", "warm_ms", "read_flush_ms", "library_call",
                      "library_read_flush_ms", "bincount_ms",
                      "torch_sum1_ms", "torch_sum1_read_flush_ms",
                      "device_ops_per_call", "callers", "main_path")),
        kernel_entry("copy_blocks", "suffix_torch/csrc/probes.cu",
                     "scripts/round3_study.py:114", probe["copy_blocks"]),
        kernel_entry("copy5_blocks", "suffix_torch/csrc/probes.cu",
                     "scripts/round3_study.py:140", probe["copy5_blocks"]),
        kernel_entry("minmax_stages", "suffix_torch/csrc/probes.cu",
                     "scripts/round3_study.py:169", probe["minmax_stages"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
