"""Framework configuration, ported from ``suffix_tpu/utils/config.py``.

A small frozen dataclass consumed by the builders and the CLI (engine
selection, padding, query batching), no flag framework. The device is a
keyword of ``build_index``, not a field: one config describes a build on
any card.
"""

from __future__ import annotations

import dataclasses

SHARDED_TODO = "the sharded build is not ported yet (ROADMAP item 15)"


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Construction-time knobs."""

    engine: str = "device"          # device | sais | native | auto
    n_devices: int | None = None    # None = all visible devices (sharded path)
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
    (``None`` = CUDA)."""
    from suffix_torch.table import SuffixTable

    if config.sharded:
        raise NotImplementedError(f"BuildConfig(sharded=True): {SHARDED_TODO}")
    return SuffixTable.new(text, engine=config.engine, device=device)
