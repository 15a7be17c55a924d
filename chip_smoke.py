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
              with build stats, certified; the phase-6 query batch on it
              (queries_device); then ``lcp_lens()``, 65,536 sampled
              adjacent pairs checked against their byte-wise common prefix.
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
   queries_hybrid — 4,096 single queries of each method on the 4 MiB
              default-built table under ``query_route="auto"`` (the host
              route, the extension's methods bound onto the table) and
              1,024 under ``"device"``, every answer equal; a batch of 64
              on the host and 65 on the device (wrappers); median µs a
              call.
   verify_device — ``verify(device=True)`` against the host certificate
              on the 4 and 64 MiB tables and on a 4 MiB table with two
              entries swapped; seconds of each form.

byte_histogram's launch counter is set to 0 just before phase 5 and read
just after phase 6 (its path is the SA-IS build); the probes' counters
(minmax_stages' by path too) just before and after the battery, which
must run the register path. The doubling and LCP path runs library
operations only, the native and hybrid phases host C++. The line before
the last is the kernel table (``{"kernels": [...]}``); the last line is
the device summary. Any failed
check raises, and the script exits non-zero without those two lines. It
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FIXTURE = ROOT / "tests" / "fixtures" / "AP009048_100000.fasta"
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


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def overlapping_count(raw: bytes, q: bytes) -> int:
    """Occurrences of ``q`` in ``raw``, overlaps included: the count of
    ``re.finditer(b"(?=" + re.escape(q) + b")", raw)``, by ``bytes.find``."""
    k, p = 0, raw.find(q)
    while p >= 0:
        k += 1
        p = raw.find(q, p + 1)
    return k


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


def check_lcp_64m(torch, lcp_ops, native, st, raw: bytes) -> None:
    """lcp_64m: ``lcp_lens()`` through the bulk ladder (wrappers count the
    ladder and Kasai calls and take the ladder's per-stage trace); the
    census in (2048, n/64]; sampled pairs and every survivor pair against
    the bytes."""
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


def build_device(torch, SuffixTable, verify, raw: bytes, phase: str,
                 label: str = LABEL_DNA, **extra):
    """A default build with stats, its route label and certificate;
    ``extra`` goes into the phase's line."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st = SuffixTable.new(raw, collect_stats=True)
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    if st.build_stats["engine"] != label:
        raise AssertionError(f"route {st.build_stats['engine']!r} != the "
                             f"JAX package's {label!r}")
    t0 = time.perf_counter()
    if not verify(raw, st.table()):
        raise AssertionError(f"{phase}: table fails the certificate")
    emit(phase, build_s=build_s, certificate_s=time.perf_counter() - t0,
         peak_device_gib=peak / 2**30, **extra, **st.build_stats)
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


def check_deep_queries(torch, search2, st, raw: bytes) -> None:
    """queries_128m_deep: the deep keyless index, the battery through the
    public batch calls, every bound equal to the flat-key engine's, 4,096
    checked on the bytes; queries per second, median of 5."""
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
    rows = {}
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
                    card: str) -> None:
    """lcp_4m_nearrep, lcp_128m_text: ``lcp_lens()`` on a survivor-dense
    table: the sampler sends it to Kasai (wrappers: Kasai once, by the
    native library; the bulk ladder never), 65,536 sampled pairs checked
    against the bytes."""
    lcp, lcp_s, calls = counted_lcp(lcp_ops, native, st)
    if calls != {"bulk": 0, "kasai": 1, "native_kasai": 1, "numpy_kasai": 0}:
        raise AssertionError(f"{phase} took {calls}; expected the native "
                             "Kasai once and no bulk ladder")
    t0 = time.perf_counter()
    max_lcp = check_lcp_sample(raw, st.table(), lcp)
    emit(phase, card=card, n=len(raw), lcp_s=lcp_s, calls=calls,
         route="native_kasai", sampled_pairs=LCP_SAMPLES, max_lcp=max_lcp,
         check_s=time.perf_counter() - t0)


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
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from suffix_torch import SuffixTable, native
    from suffix_torch.device import resolve_device
    from suffix_torch.ops import kernels, probes, sais, search2
    from suffix_torch.ops import lcp as lcp_ops
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
    st_d = build_device(torch, SuffixTable, verify_suffix_array, raw,
                        "build_4m_device")
    check_queries(st_d, raw, np.random.default_rng(SEED + 2),
                  phase="queries_device")
    t0 = time.perf_counter()
    lcp = st_d.lcp_lens()
    lcp_s = time.perf_counter() - t0
    emit("lcp_4m", lcp_s=lcp_s, max_lcp=check_lcp_sample(raw, st_d.table(),
                                                          lcp),
         sampled_pairs=LCP_SAMPLES)

    raw64 = (np.random.default_rng(SEED + 64).integers(
        0, 4, size=N_TEXT_64M, dtype=np.uint8) + 97).tobytes()
    st64 = build_device(torch, SuffixTable, verify_suffix_array, raw64,
                        "build_64m_device")
    check_lcp_64m(torch, lcp_ops, native, st64, raw64)
    profile(torch, "lcp_64m", st64.lcp_lens, LCP_SCOPES)
    tab64 = st64.table()  # for verify_device
    del st64

    # The other routes of the default build at 4 MiB: rounds at full
    # width, and the two-phase engine.
    repeats = dna_repeats()
    build_device(torch, SuffixTable, verify_suffix_array, repeats,
                 "build_4m_device_repeats", LABEL_DNA_REPEATS)
    text = text_repeats()
    build_device(torch, SuffixTable, verify_suffix_array, text,
                 "build_4m_device_text", LABEL_TEXT_REPEATS)
    nearrep = nearrep_text()
    st_near = build_device(torch, SuffixTable, verify_suffix_array, nearrep,
                           "build_4m_device_nearrep", LABEL_NEARREP)

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
    st128 = build_device(torch, SuffixTable, verify_suffix_array, text128,
                         "build_128m_text", LABEL_TEXT_128M,
                         generate_s=time.perf_counter() - t0)
    check_deep_queries(torch, search2, st128, text128)
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
    check_lcp_kasai(lcp_ops, native, st_near, nearrep, "lcp_4m_nearrep",
                    card)
    del st_near
    check_lcp_kasai(lcp_ops, native, st128, text128, "lcp_128m_text", card)
    del st128, text128
    check_hybrid(native, search2, st_d, raw, card)
    check_verify_device(SuffixTable, [("dna_4m", raw, st_d.table()),
                                      ("dna_64m", raw64, tab64)], card)
    del st_d, raw64, tab64

    print(json.dumps({"kernels": [
        kernel_entry("byte_histogram", "suffix_torch/csrc/histogram.cu",
                     "suffix_tpu/ops/pallas_kernels.py:51",
                     {**hist, "launches": launches},
                     ("input", "warm_ms", "read_flush_ms", "library_call",
                      "library_read_flush_ms", "bincount_ms",
                      "torch_sum1_ms", "torch_sum1_read_flush_ms",
                      "device_ops_per_call")),
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
