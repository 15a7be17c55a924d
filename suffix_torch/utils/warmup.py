"""Ahead-of-time warming of the serving pipeline, ported from
``suffix_tpu/utils/warmup.py``.

Eager PyTorch compiles nothing, but the first call of each program on a
card still pays for the CUDA context, cuBLAS/CUB workspace and the
caching allocator's growth to the program's peak. ``warm`` runs the JAX
package's program list once at the same power-of-two buckets
(ops/padding.py): the build, the two-phase and adaptive builds, the query
index, the query batches and the LCP, so a serving process meets its
first request with all of that in place. Where a build makes an adaptive
plan, the port also counts the text's bytes on the card once (the
``byte_histogram`` kernel, which the JAX package does not run).
``warm_sharded`` does the same for the sharded build's programs on every
rank.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from suffix_torch.device import resolve_device, sync


def warm(n_bytes: int,
         query_batches: tuple[int, ...] = (4096, 65536),
         query_lens: tuple[int, ...] = (16,),
         lcp: bool = True,
         alphabet_sizes: tuple[int, ...] = (4,),
         verbose: bool = True,
         device=None) -> list[tuple[str, float]]:
    """Run the full serving pipeline once for a corpus of ``n_bytes`` on
    ``device`` (``None`` = CUDA).

    ``alphabet_sizes``: corpus classes whose alphabet-adaptive packed
    build (ops/prefix_doubling._packed_words) should be warmed in
    addition to the byte-ladder engine: pass the distinct-byte counts of
    the deployment's corpora (4 = DNA; () to skip).

    Returns [(program, seconds)] for each warmed program.
    """
    from suffix_torch.ops import search2
    from suffix_torch.ops.lcp import _lcp_keyed
    from suffix_torch.ops.padding import PAD, bucket_size
    from suffix_torch.ops.prefix_doubling import (
        ADAPTIVE_PACK_MIN, I32, TIE_CAP_FRAC, TWO_PHASE_MIN, _adaptive_plan,
        _device_byte_counts, _doubling, _initial_words, _packed_words,
        _suffix_array_padded, _two_phase_build, pick_init_words)

    dev = resolve_device(device)
    timings: list[tuple[str, float]] = []

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(dev)
        dt = time.perf_counter() - t0
        timings.append((name, dt))
        if verbose:
            print(f"  warmed {name}: {dt:.1f}s", flush=True)
        return out

    def upload(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(dev)

    n_pad = bucket_size(max(n_bytes, 1))
    rng = np.random.default_rng(0)
    padded = np.full((n_pad,), PAD, np.int32)
    padded[:n_bytes] = rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    t_dev = upload(padded)

    iw = pick_init_words(n_pad)
    sa_full = step(f"build n={n_pad} (init_words={iw})",
                   lambda: _suffix_array_padded(t_dev, iw))
    if n_pad >= TWO_PHASE_MIN:
        # The two-phase route (what suffix_array_bytes runs on byte-ladder
        # / text-class corpora at this size), end to end on the random
        # corpus.
        step(f"two-phase build n={n_pad}",
             lambda: _two_phase_build(
                 _doubling(_initial_words(t_dev, iw), 3 * iw, I32,
                           n_pad // TIE_CAP_FRAC), n_pad))
    if n_pad >= ADAPTIVE_PACK_MIN:
        # The plan's byte counts (byte_histogram: its library, built on
        # first use, and its occupancy query), as a build counts its text.
        step(f"byte counts n={n_pad}", lambda: _device_byte_counts(t_dev))
        for sigma in alphabet_sizes:
            sample = (rng.integers(0, max(int(sigma), 2),
                                   size=min(n_bytes, 4096),
                                   dtype=np.uint8) + 97)
            plan = _adaptive_plan(sample, n_pad)
            if plan is None:
                continue
            _, bits, cpw, n_words = plan
            codes = np.zeros((n_pad,), np.int32)
            codes[:n_bytes] = rng.integers(1, int(sigma) + 1,
                                           size=n_bytes, dtype=np.int32)
            c_dev = upload(codes)
            step(f"adaptive build n={n_pad} sigma={sigma} "
                 f"({bits}b x {cpw * n_words}ch)",
                 lambda c=c_dev, w=n_words, b=bits, k=cpw:
                 _doubling(_packed_words(c, w, b, k), w * k, I32).sa)
    # Query/LCP programs take the REAL table layout: sa[0:n) = suffix
    # array, zero-filled past n (padding suffixes sliced off).
    sa = torch.zeros((n_pad,), dtype=I32, device=dev)
    sa[:n_bytes] = sa_full[n_pad - n_bytes:]

    pk, pk_fence, pk_block = step(
        f"query_index n={n_pad}",
        lambda: search2.build_query_index(t_dev, sa, n_bytes))

    for q_pad in query_batches:
        for m_pad in query_lens:
            q = torch.zeros((q_pad, m_pad), dtype=I32, device=dev)
            ql = torch.ones((q_pad,), dtype=I32, device=dev)
            step(f"queries q={q_pad} m={m_pad} n={n_pad}",
                 lambda q=q, ql=ql, m=m_pad: search2.bounds_batch_merge(
                     t_dev, n_bytes, sa, n_bytes, pk_fence, pk_block, q, ql,
                     m))

    if lcp:
        step(f"lcp n={n_pad}",
             lambda: _lcp_keyed(t_dev, n_bytes, sa, n_bytes, pk))
    return timings


def warm_sharded(n_bytes: int, n_devices: int, verbose: bool = True,
                 device=None) -> list[tuple[str, float]]:
    """Run the sharded build's programs once for a corpus of ``n_bytes``
    over ``n_devices`` ranks on ``device``'s type (``None`` = CUDA): the
    one-shot SPMD build, the stepped build's initial rank and one round
    step, at the block length the sharded build itself uses
    (``dist_build._local_bucket``). Returns rank 0's [(program,
    seconds)], which the lead process prints."""
    from suffix_torch.parallel import launch

    timings = launch.run(_warm_sharded_rank, n_devices, n_bytes,
                         device=device)
    if verbose and timings is not None and launch.is_lead():
        for name, dt in timings:
            print(f"  warmed {name}: {dt:.1f}s", flush=True)
    return timings


def _warm_sharded_rank(mesh, n_bytes: int):
    from suffix_torch.ops.padding import PAD
    from suffix_torch.parallel import dist_build as db

    timings: list[tuple[str, float]] = []

    def step(name, fn):
        t0 = time.perf_counter()
        out = fn()
        sync(mesh.device)
        dt = time.perf_counter() - t0
        timings.append((name, dt))
        return out

    n_dev = mesh.world_size
    n_local = db._local_bucket(n_bytes, n_dev)
    rng = np.random.default_rng(0)
    padded = np.full((n_local * n_dev,), PAD, np.int32)
    padded[:n_bytes] = rng.integers(0, 256, size=n_bytes, dtype=np.uint8)
    lo = mesh.rank * n_local
    block = torch.from_numpy(padded[lo:lo + n_local].copy()).to(mesh.device)
    tag = f"L={n_local} D={n_dev}"
    step(f"sharded build {tag}", lambda: db._dist_build(block, n_local, mesh))
    rank0 = step(f"sharded initial rank {tag}",
                 lambda: db._packed_initial_rank(block, mesh))
    step(f"sharded round step {tag}",
         lambda: db._round_body(rank0, 3, n_local, mesh))
    return timings
