"""The multi-rank dry run: the whole sharded stack on an ``n``-rank mesh.

Counterpart of ``dryrun_multichip`` in the repository's
``__graft_entry__.py`` (which lies outside the JAX package): on a mixed
corpus of about ``n_bytes`` it runs, in this order,

1. a tiny sharded build against ``naive_table`` (fails fast on the mesh's
   wiring);
2. the one-shot sharded build of the mixed corpus (random DNA,
   English-like words and raw bytes from seed ``0xC0FFEE``, as JAX's);
3. the stepped build of a repetitive tiling with a round hook;
4. parity of both tables with the single-device build;
5. ``ShardedQueryIndex(corpus, mesh, sa=sa, host_sa=False)``: 13
   patterns, each held against a ``bytes.find`` loop;
6. the sharded LCP against Kasai,

and prints one ``dryrun_multichip OK: {...}`` line with JAX's keys.
Every check raises on a mismatch.

``per_round_collectives`` counts the port's own exchanges in one round of
``dist_build.py::_round_body`` (the largest over the stepped build's
rounds), not JAX's formula: the halo fetch's one exchange (when any
block distance lies inside the mesh), two block-bitonic sorts of S =
log2(D)(log2(D) + 1) / 2 merge-split exchanges each (five arrays, then
two), the left boundary's one transfer and one all-gather of the
re-rank totals; ``bytes_per_rank`` is what one rank sends at most.

    python -m suffix_torch.parallel.dryrun 8 --platform cpu
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from suffix_torch.parallel import launch
from suffix_torch.parallel.mesh import AXIS


def mixed_corpus(n_bytes: int) -> bytes:
    """JAX's dry-run corpus: a third random DNA, a third words, the rest
    raw bytes, from seed 0xC0FFEE."""
    rng = np.random.default_rng(0xC0FFEE)
    third = n_bytes // 3
    words = [b"the", b"quick", b"brown", b"fox", b"was", b"over", b"dog"]
    english = b" ".join(words[i] for i in rng.integers(0, len(words),
                                                       size=third // 4))
    return (bytes((rng.integers(0, 4, size=third, dtype=np.uint8) + 97))
            + english[:third]
            + bytes(rng.integers(0, 256, size=n_bytes - third
                                 - min(third, len(english)),
                                 dtype=np.uint8)))


def round_exchanges(n_dev: int, n_local: int, k: int) -> dict:
    """Exchanges, all-gathers and bytes one rank sends in one
    ``_round_body`` at step ``k`` over ``n_dev`` ranks of ``n_local``."""
    if n_dev == 1:
        return {"p2p_exchanges": 0, "all_gathers": 0, "bytes_per_rank": 0}
    logd = n_dev.bit_length() - 1
    stages = logd * (logd + 1) // 2
    shifts = [m * k // n_local for m in (1, 2, 3)]
    halo = len({d for s in shifts for d in (s, s + 1) if 0 < d < n_dev})
    return {"p2p_exchanges": 2 * stages + 1 + (halo > 0), "all_gathers": 1,
            "bytes_per_rank": 4 * n_local * (7 * stages + halo) + 4 * 8}


def occurrences(raw: bytes, q: bytes) -> list[int]:
    out, i = [], raw.find(q)
    while i != -1:
        out.append(i)
        i = raw.find(q, i + 1)
    return out


def _dryrun_rank(mesh, n_bytes: int, rep_tiles: int) -> dict:
    """The dry run on one rank of ``mesh``; every rank returns the
    summary."""
    from suffix_torch import native
    from suffix_torch.ops.lcp import kasai_host
    from suffix_torch.ops.naive import naive_table
    from suffix_torch.ops.prefix_doubling import suffix_array_bytes
    from suffix_torch.parallel import dist_build
    from suffix_torch.parallel.dist_query import ShardedQueryIndex

    n_dev, dev = mesh.world_size, mesh.device
    data0 = (b"the quick brown fox was quick. " * 6)[:23 * n_dev]
    if not np.array_equal(dist_build.suffix_array_sharded(data0, mesh),
                          naive_table(data0)):
        raise AssertionError("sharded SA does not match oracle (smoke)")

    corpus = mixed_corpus(n_bytes)
    t0 = time.perf_counter()
    sa = dist_build.suffix_array_sharded(corpus, mesh)
    build_s = time.perf_counter() - t0
    n_local = dist_build._local_bucket(len(corpus), n_dev)

    rep = np.tile(np.frombuffer(b"abracadabra-zyx!", np.uint8), rep_tiles)
    rounds: list[int] = []
    sa_rep = dist_build.suffix_array_sharded_stepped(
        rep, mesh, round_hook=lambda k, done: rounds.append(int(k)))
    rep_local = dist_build._local_bucket(len(rep), n_dev)
    coded = dist_build._sharded_adaptive_plan(
        rep, rep_local * n_dev, rep_local) is not None
    # A round body at step k hands k * 4 to the hook.
    per = [round_exchanges(n_dev, rep_local, k // 4)
           for k in rounds[int(coded):]] or [round_exchanges(n_dev, 1, 0)]
    per_round = {key: max(p[key] for p in per) for key in per[0]}

    if not np.array_equal(sa, suffix_array_bytes(corpus, device=dev)):
        raise AssertionError("sharded SA != single-device SA")
    if not np.array_equal(sa_rep, suffix_array_bytes(rep.tobytes(),
                                                     device=dev)):
        raise AssertionError("stepped sharded SA != single-device "
                             "(repetitive)")

    sqi = ShardedQueryIndex(corpus, mesh, sa=sa, host_sa=False)
    if sqi._sa_host is not None:
        raise AssertionError("host_sa=False must drop the host table")
    third = len(corpus) // 3
    pats = [b"quick", b"fox was quick", b"zzz-not-there", b"q",
            b"the quick brown fox was quick. the quick"]
    pats += [corpus[i:i + 12] for i in range(third, third + 8)]
    for p in pats:
        got = np.sort(sqi.positions(p))
        if not np.array_equal(got, np.asarray(occurrences(corpus, p),
                                              dtype=got.dtype)):
            raise AssertionError(f"sharded positions mismatch for {p!r}")

    lcp = sqi.lcp_lens()
    want = (native.kasai(corpus, sa) if native.available()
            else kasai_host(np.frombuffer(corpus, np.uint8), sa))
    if not np.array_equal(lcp, np.asarray(want)):
        raise AssertionError("sharded LCP mismatch")

    return {
        "devices": n_dev, "mesh": {AXIS: n_dev},
        "n": len(corpus), "n_local": n_local,
        "build_s_1MB": round(build_s, 1),
        "stepped_rounds_64K_repetitive": len(rounds),
        "per_round_collectives": per_round,
        "surfaces": {"build_1MB": "ok", "stepped+checkpoint_64K": "ok",
                     f"query({len(pats)} patterns)": "ok", "lcp_1MB": "ok"},
    }


def dryrun_multichip(n_devices: int, n_bytes: int = 1 << 20,
                     rep_tiles: int = 4096, device=None) -> dict | None:
    """The dry run over ``n_devices`` ranks on ``device``'s type (``None``
    = CUDA) through ``launch.run``: the caller's process group, one rank
    in this process, or ranks started for the call. The lead process
    prints the summary line; rank 0's summary comes back (``None`` on a
    rank outside the mesh)."""
    summary = launch.run(_dryrun_rank, n_devices, n_bytes, rep_tiles,
                         device=device)
    if summary is not None and launch.is_lead():
        print("dryrun_multichip OK: " + json.dumps(summary), flush=True)
    return summary


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m suffix_torch.parallel.dryrun",
                                description="multi-rank dry run of the "
                                            "sharded stack")
    p.add_argument("n_devices", type=int, nargs="?", default=8)
    p.add_argument("--platform", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--bytes", type=int, default=1 << 20)
    p.add_argument("--rep-tiles", type=int, default=4096)
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, args.bytes, args.rep_tiles,
                     device=args.platform)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
