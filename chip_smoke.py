#!/usr/bin/env python3
"""Drive the PyTorch port (``suffix_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device   — CUDA present; torch/CUDA versions; card name and power limit.
2. build    — compile the CUDA kernels from ``suffix_torch/csrc`` (nvcc).
3. kernels  — each kernel against its plain PyTorch version on the card,
              exact equality, and its time beside the plain version's, one
              PyTorch library call's and the memory bound.
4. golden   — SA-IS build of the 100 KB E. coli fixture against its golden
              SA digest.
5. build_4m — the main path: SA-IS build of a 4 MiB random DNA text
              (seed 0xD4A), certified by the O(n) suffix-array certificate.
6. queries  — the main path continued: one count/positions batch of
              262,144 14-byte queries drawn from the text, 4,096 random
              (mostly absent) ones, 256 of 24 and of 48 bytes, and the empty
              query, checked against the raw bytes; queries per second.
7. profile  — torch.profiler over one more 4 MiB build and one 262,144-query
              batch: device busy share, top kernels, SA-IS phase scopes.

Kernel launch counters are set to 0 just before phase 5 and read just
after phase 6. The line before the last is the kernel table
(``{"kernels": [...]}``); the last line is the device summary. Any failed
check raises, and the script exits non-zero without those two lines. It
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (data sheet)
SEED = 0xD4A
N_TEXT = 1 << 22
N_QUERIES = 262144
QLEN = 14
# torch.profiler scopes of ops/sais.py::_derive_sa
SAIS_SCOPES = ("S1_classify_buckets", "S2_L_phase_round", "S3_S_phase_round")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def time_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
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


def check_histogram(torch, kernels, sais, raw: bytes) -> dict:
    """Phase 3: byte_histogram against byte_histogram_plain on the card."""
    dev = torch.device("cuda")
    rng = np.random.default_rng(0xC0FFEE)
    cases = [(f"uniform_n{n}", rng.integers(0, 258, size=n), 258)
             for n in (100, 1024, 3 * 1024, 4 * 1024 - 7)]
    cases += [(f"out_of_range_bins{nb}", rng.integers(-5, 300, size=2048), nb)
              for nb in (258, 512)]
    cases.append(("empty", np.empty(0), 258))
    text = torch.from_numpy(np.frombuffer(raw, np.uint8).astype(np.int32))
    text = text.to(dev)
    is_s, _ = sais.classify_types(text)
    sym = (text + 1).to(torch.int32)
    s_sym = torch.where(is_s, sym, -1)
    cases += [("text_sym_4MiB", sym, 258), ("text_s_sym_4MiB", s_sym, 258)]
    max_err = 0
    for name, vals, nb in cases:
        x = (vals if isinstance(vals, torch.Tensor)
             else torch.from_numpy(vals.astype(np.int32)).to(dev))
        got = kernels.byte_histogram(x, nb)
        want = kernels.byte_histogram_plain(x, nb)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max())
        max_err = max(max_err, err)
        if err != 0 or got.shape != (nb,):
            raise AssertionError(f"byte_histogram differs from its plain "
                                 f"version on {name}: max |err| {err}")
    n = s_sym.shape[0]
    in_range = s_sym[(s_sym >= 0) & (s_sym < 258)]
    timing = {
        "ms": time_ms(torch, lambda: kernels.byte_histogram(s_sym, 258)),
        "plain_ms": time_ms(
            torch, lambda: kernels.byte_histogram_plain(s_sym, 258)),
        # Yardstick only: one library call on the in-range values.
        "library_ms": time_ms(
            torch, lambda: torch.bincount(in_range, minlength=258)),
        # Each input read once, each output written once.
        "bound_ms": (4 * n + 4 * 258) / HBM_BYTES_PER_S * 1e3,
    }
    emit("kernels", cases=[c[0] for c in cases], max_abs_err=max_err,
         n=n, n_bins=258, **timing)
    return {"max_abs_err": max_err, **timing}


def profile(torch, label: str, fn) -> None:
    """Device busy share and top kernels of one call of ``fn``, from
    ``torch.profiler``; the SA-IS derivation's scopes are reported with
    their host and device spans."""
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
        if e.key in SAIS_SCOPES:
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
                      for e in top])


def check_queries(st, raw: bytes, rng: np.random.Generator) -> list[bytes]:
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
    emit("queries", n_queries=len(queries), first_batch_s=first_s,
         sampled_checks=checked, matches=int(counts.sum()),
         absent_random14=int((counts[N_QUERIES:N_QUERIES + 4096] == 0).sum()),
         batch_262144x14_s=batch_s, batch_times_s=times,
         queries_per_s=N_QUERIES / batch_s)
    return drawn14


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from suffix_torch import SuffixTable
    from suffix_torch.ops import kernels, sais
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
    hist = check_histogram(torch, kernels, sais, raw)

    fixture = FIXTURE.read_bytes()
    st100 = SuffixTable.new(fixture, engine="sais", collect_stats=True)
    digest = hashlib.sha256(st100.table().astype(np.uint32).tobytes())
    if digest.hexdigest() != GOLDEN_SA_100K:
        raise AssertionError("100 KB fixture SA differs from the golden digest")
    emit("golden", n=len(fixture), **st100.build_stats)

    # ---- the main path: counters from 0, build + queries, counters read --
    kernels.byte_histogram.launches = 0
    st = SuffixTable.new(raw, engine="sais", collect_stats=True)
    build_launches = kernels.byte_histogram.launches
    if build_launches < 2:
        raise AssertionError(f"byte_histogram launched {build_launches} "
                             "times in the 4 MiB build; expected >= 2")
    t0 = time.perf_counter()
    if not verify_suffix_array(raw, st.table()):
        raise AssertionError("4 MiB table fails the suffix-array certificate")
    emit("build_4m", certificate_s=time.perf_counter() - t0,
         histogram_launches=build_launches, **st.build_stats)
    drawn14 = check_queries(st, raw, rng)
    launches = kernels.byte_histogram.launches

    # ---- where the time goes (after the counters were read) -------------
    profile(torch, "build_4m",
            lambda: SuffixTable.new(raw, engine="sais"))
    profile(torch, "queries_262144x14", lambda: st.count_batch(drawn14))

    print(json.dumps({"kernels": [{
        "name": "byte_histogram",
        "route": "cuda",
        "source": "suffix_torch/csrc/histogram.cu",
        "replaces": "suffix_tpu/ops/pallas_kernels.py:51",
        "launches": launches,
        "max_abs_err": hist["max_abs_err"],
        "ms": hist["ms"],
        "plain_ms": hist["plain_ms"],
        "bound_ms": hist["bound_ms"],
        "bound_by": "bytes",
        "library_ms": hist["library_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
