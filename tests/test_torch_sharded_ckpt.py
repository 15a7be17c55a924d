"""The port's stepped sharded build with checkpoints
(``suffix_torch/parallel/dist_build.py::suffix_array_sharded_stepped``)
against the JAX package's: the stepped and fault cases of
``tests/test_sharded.py`` and ``tests/test_fault_injection.py``.

- ``round_hook``'s (k, done) sequence equals JAX's at the same mesh size
  (1, 2 and 4 ranks), and the table equals the oracle's;
- a resume from every round's checkpoint gives the same table and runs
  exactly the remaining rounds;
- a rank one round behind makes the others rewind to their ``.prev``;
- a corrupt checkpoint (on one rank or all) restarts clean;
- a rank killed with SIGKILL between rounds, then a resume in a new
  world, gives the same table from a later round;
- checkpoints cross-load with JAX's at one rank (JAX's 4-block file
  included).

The processes: one 2-rank gloo world that is killed, then one 4-rank
world for everything else (its first ranks make the smaller meshes).
Tolerance: exact equality.
"""

import os
import shutil
import signal

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# One intra-op thread: the suite runs in several processes at once, and
# a thread a core each makes them contend.
torch.set_num_threads(1)

from torch.multiprocessing.spawn import ProcessExitedException  # noqa: E402

from suffix_torch.ops.naive import naive_table  # noqa: E402
from suffix_torch.parallel import dist_build as db  # noqa: E402
from suffix_torch.parallel import launch  # noqa: E402

RAND600 = np.random.default_rng(600).integers(
    0, 8, size=600, dtype=np.uint8).tobytes()
ABRA = b"abracadabra" * 300  # LCPs near n: the whole round ladder
# Period 9: ties survive the coded first round (with the floor lowered).
PERIOD9 = np.tile(np.frombuffer(b"abcabzbb!", np.uint8), 600).tobytes()
TEXTS = {"rand600": RAND600, "abra": ABRA, "period9": PERIOD9}
ADAPTIVE_FLOOR = 16  # ADAPTIVE_PACK_MIN for period9, as JAX's test sets it
STOP_AFTER = 2  # rounds persisted before a hook stops a build


class Stop(Exception):
    """Raised by a round hook to stop a build between rounds."""


def _stepped(data, mesh, **kw):
    """(table, [(k, done)]) of one stepped build; ``stop_after`` rounds
    then ``Stop`` when given, ``copy_to`` copies this rank's checkpoint
    after each round i to ``{copy_to}.r{i}.{rank}``."""
    from suffix_torch.ops import prefix_doubling as pd

    stop_after = kw.pop("stop_after", None)
    copy_to = kw.pop("copy_to", None)
    seen = []

    def hook(k, done):
        if copy_to is not None:
            shutil.copy(db._ckpt_path(kw["checkpoint_path"], mesh),
                        f"{copy_to}.r{len(seen)}.{mesh.rank}")
        seen.append((k, done))
        if stop_after is not None and len(seen) == stop_after:
            raise Stop

    floor = pd.ADAPTIVE_PACK_MIN
    if data is PERIOD9:
        pd.ADAPTIVE_PACK_MIN = ADAPTIVE_FLOOR
    try:
        return db.suffix_array_sharded_stepped(data, mesh, round_hook=hook,
                                               **kw), seen
    except Stop:
        return None, seen
    finally:
        pd.ADAPTIVE_PACK_MIN = floor


def _killed_world(mesh, ckpt: str):
    """Rank 1 dies by SIGKILL after persisting round STOP_AFTER."""

    def hook(k, done):
        hook.rounds += 1
        if mesh.rank == 1 and hook.rounds == STOP_AFTER:
            os.kill(os.getpid(), signal.SIGKILL)

    hook.rounds = 0
    db.suffix_array_sharded_stepped(ABRA, mesh, checkpoint_path=ckpt,
                                    round_hook=hook)


def _ckpt_cases(mesh, tmp: str, killed: str, jax_ckpt: str):
    import torch.distributed as dist

    from suffix_torch.parallel.mesh import make_mesh

    out = {}
    for n in (1, 2, 4):
        m = make_mesh(n, device="cpu")
        if m is None:
            continue
        for name, data in TEXTS.items():
            out["hooks", n, name] = _stepped(data, m)
        # Resume from every round's checkpoint (each rank its own file).
        if n > 1:
            for name in ("rand600", "abra"):
                base = f"{tmp}/each_{n}_{name}"
                _, full = _stepped(TEXTS[name], m, checkpoint_path=base,
                                   copy_to=f"{base}.copy")
                runs = []
                for i in range(len(full)):
                    path = f"{base}.from{i}"
                    shutil.copy(f"{base}.copy.r{i}.{m.rank}",
                                db._ckpt_path(path, m))
                    runs.append(_stepped(TEXTS[name], m, checkpoint_path=path,
                                         resume=True))
                out["each", n, name] = full, runs

    m2 = make_mesh(2, device="cpu")
    m1 = make_mesh(1, device="cpu")
    if m2 is not None:
        # Rank 1 lost its last round: rank 0 rewinds to its .prev.
        path = f"{tmp}/behind.npz"
        _stepped(RAND600, m2, checkpoint_path=path, stop_after=STOP_AFTER)
        if m2.rank == 1:
            os.replace(path + ".p1.prev", path + ".p1")
        dist.barrier(group=m2.group)
        out["behind"] = _stepped(RAND600, m2, checkpoint_path=path,
                                 resume=True)
        # One rank's file is corrupt: every rank restarts clean.
        path = f"{tmp}/corrupt2.npz"
        _stepped(RAND600, m2, checkpoint_path=path, stop_after=STOP_AFTER)
        if m2.rank == 0:
            with open(path + ".p0", "wb") as f:
                f.write(b"not a real npz file")
            os.remove(path + ".p0.prev")
        dist.barrier(group=m2.group)
        out["corrupt2"] = _stepped(RAND600, m2, checkpoint_path=path,
                                   resume=True)
        out["killed"] = _stepped(ABRA, m2, checkpoint_path=killed,
                                 resume=True)
    if m1 is not None:
        path = f"{tmp}/corrupt1.npz"
        with open(path, "wb") as f:
            f.write(b"not a real npz file")
        out["corrupt1"] = _stepped(RAND600, m1, checkpoint_path=path,
                                   resume=True)
        out["from_jax"] = _stepped(RAND600, m1, checkpoint_path=jax_ckpt,
                                   resume=True)
        out["for_jax"] = _stepped(RAND600, m1,
                                  checkpoint_path=f"{tmp}/for_jax.npz",
                                  stop_after=STOP_AFTER)
    return out


def _jax_stepped(data, n_dev: int, **kw):
    """(table, [(k, done)]) of JAX's stepped build on ``n_dev`` devices."""
    from suffix_tpu.ops import prefix_doubling as jpd
    from suffix_tpu.parallel.dist_build import suffix_array_sharded_stepped
    from suffix_tpu.parallel.mesh import make_mesh

    stop_after = kw.pop("stop_after", None)
    seen = []

    def hook(k, done):
        seen.append((int(k), bool(done)))
        if stop_after is not None and len(seen) == stop_after:
            raise Stop

    floor = jpd.ADAPTIVE_PACK_MIN
    if data is PERIOD9:
        jpd.ADAPTIVE_PACK_MIN = ADAPTIVE_FLOOR
    try:
        return suffix_array_sharded_stepped(data, make_mesh(n_dev),
                                            round_hook=hook, **kw), seen
    except Stop:
        return None, seen
    finally:
        jpd.ADAPTIVE_PACK_MIN = floor


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    pytest.importorskip("jax")
    tmp = tmp_path_factory.mktemp("ckpt")
    killed = str(tmp / "killed.npz")
    with pytest.raises((ProcessExitedException, RuntimeError)):
        launch.spawn(_killed_world, 2, killed, device="cpu")
    ks = []
    for suffix in (".p0", ".p1"):
        with np.load(killed + suffix) as z:
            assert not bool(z["done"])
            ks.append(int(z["k"]))
    jax_ckpt = str(tmp / "jax4.npz")
    _jax_stepped(RAND600, 4, checkpoint_path=jax_ckpt, stop_after=STOP_AFTER)
    out = launch.spawn(_ckpt_cases, 4, str(tmp), killed, jax_ckpt,
                       device="cpu")
    return out, min(ks), str(tmp)


@pytest.mark.parametrize("n", (1, 2, 4))
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_round_hook_sequence_matches_jax(world, n, name):
    got, seen = world[0]["hooks", n, name]
    want, want_seen = _jax_stepped(TEXTS[name], n)
    assert seen == want_seen
    assert seen[-1][1] or seen[-1][0] >= len(TEXTS[name])
    assert np.array_equal(got, want)
    assert np.array_equal(got, naive_table(TEXTS[name]))
    if name == "period9":
        assert seen[0][0] > 3 and len(seen) >= 2  # coded step 0, then rounds


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("name", ("abra", "rand600"))
def test_resume_from_every_round(world, n, name):
    full, runs = world[0]["each", n, name]
    want = naive_table(TEXTS[name])
    assert len(runs) == len(full) >= 3
    for i, (got, seen) in enumerate(runs):
        assert np.array_equal(got, want), i
        assert seen == full[i + 1:], i


def test_prev_rewinds_a_rank_ahead(world):
    got, seen = world[0]["behind"]
    _, full = world[0]["hooks", 2, "rand600"]
    assert np.array_equal(got, naive_table(RAND600))
    assert seen == full[STOP_AFTER - 1:]


@pytest.mark.parametrize("key", ("corrupt1", "corrupt2"))
def test_corrupt_checkpoint_restarts_clean(world, key):
    got, seen = world[0][key]
    n = 1 if key == "corrupt1" else 2
    assert np.array_equal(got, naive_table(RAND600))
    assert seen == world[0]["hooks", n, "rand600"][1]


def test_sigkill_between_rounds_then_resume(world):
    got, seen = world[0]["killed"]
    k_at_death = world[1]
    assert k_at_death >= 12
    assert seen[0][0] > k_at_death
    assert np.array_equal(got, naive_table(ABRA))


def test_checkpoints_cross_load_with_jax(world):
    got, seen = world[0]["from_jax"]
    _, full = _jax_stepped(RAND600, 1)
    assert np.array_equal(got, naive_table(RAND600))
    assert seen == full[STOP_AFTER:]
    port_ckpt = os.path.join(world[2], "for_jax.npz")
    with np.load(port_ckpt) as z:
        assert sorted(z.files) == ["done", "k", "los", "n_total", "rank",
                                   "sa"]
        assert z["los"].dtype == np.int64 and z["rank"].dtype == np.int32
    want, jseen = _jax_stepped(RAND600, 1, checkpoint_path=port_ckpt,
                               resume=True)
    assert np.array_equal(want, got)
    assert jseen == full[STOP_AFTER:]
