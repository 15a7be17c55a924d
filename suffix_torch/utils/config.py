"""Framework configuration, ported from ``suffix_tpu/utils/config.py``.

A small frozen dataclass consumed by the builders and the CLI (engine
selection, the sharded build, padding, query batching), no flag
framework. The device is a keyword of ``build_index``, not a field: one
config describes a build on any card.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Construction-time knobs."""

    engine: str = "device"          # device | sais | native | auto
    n_devices: int | None = None    # None = one rank a card (sharded path)
    sharded: bool = False           # use the sharded builder
    checkpoint_path: str | None = None
    resume: bool = False
    min_pad: int = 16               # smallest padded buffer


@dataclasses.dataclass(frozen=True)
class QueryConfig:
    """Query-engine knobs."""

    engine: str = "merge"           # merge | probe
    max_batch: int = 1 << 16        # queries per device dispatch
    pad_query_to: int = 8           # minimum padded query width


DEFAULT_BUILD = BuildConfig()
DEFAULT_QUERY = QueryConfig()


def build_index(text, config: BuildConfig = DEFAULT_BUILD, *, device=None):
    """Config-driven index construction (single entry point) on ``device``
    (``None`` = CUDA).

    ``sharded=True`` builds over ``n_devices`` ranks (``launch.run``: the
    caller's process group, or ranks started for the call), stepped with
    checkpoints when ``checkpoint_path`` is set; rank 0's table comes
    back (``None`` on a rank outside the mesh)."""
    from suffix_torch.table import SuffixTable, _as_bytes

    if config.sharded:
        from suffix_torch.parallel import launch
        from suffix_torch.parallel.dist_build import build_table

        raw, was_str = _as_bytes(text)
        table = launch.run(build_table, config.n_devices, raw,
                           config.checkpoint_path, config.resume,
                           device=device)
        if table is None:
            return None
        return SuffixTable(raw, table, _was_str=was_str, device=device)
    return SuffixTable.new(text, engine=config.engine, device=device)
