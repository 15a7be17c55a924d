"""A text held to its source's published statistics (alphabet size, mean
and max LCP), made on the device from the seed in a few large calls and
copied to the host as the bytes a user indexes.

The configuration's file gives, besides ``n_bytes``:

- ``background``: ``{"kind": "iid", "symbols": "ACGT", "weights": [...]}``
  (independent symbols) or ``{"kind": "words"}`` (``benchmark/words.py``);
- ``runs``: ``[[symbol, length, count], ...]``, runs of one byte;
- ``sprinkle``: ``{"bytes": ..., "count": k}``, each byte at ``k`` places
  (``bytes`` an ASCII string or a list of ``[lo, hi]`` ranges);
- ``repeats``: ``[[length, count], ...]``, exact copies of other places
  of the text, with a differing byte on both sides of each copy. A copy
  of length ``l`` adds neighbouring suffixes with common prefixes
  ``l, l-1, ..., 1``: about ``l * (l + 1) / 2`` to the LCP sum, and the
  longest sets the text's max LCP;
- ``margin``: two bytes; a copy's side byte is the first, or the second
  where the first equals the source's.

Every seed gets the same counts and lengths, at other places. Runs and
sprinkled bytes take distinct cells of an even grid; copies and their
sources take disjoint slots, so no copy reads another.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark import words
from benchmark.rng import generator, stream_seed


def byte_values(spec) -> list[int]:
    """The bytes of a ``sprinkle`` entry."""
    if isinstance(spec, str):
        return list(spec.encode("ascii"))
    return [b for lo, hi in spec for b in range(lo, hi + 1)]


def background(cfg: dict, n: int, rng, gen, device) -> torch.Tensor:
    bg = cfg["background"]
    if bg["kind"] == "words":
        return words.make(n, rng, gen, device)
    if bg["kind"] != "iid":
        raise ValueError(f"unknown background {bg['kind']!r}")
    w = np.asarray(bg["weights"], np.float64)
    cdf = torch.from_numpy(np.cumsum(w / w.sum())).to(device)
    lut = torch.tensor(list(bg["symbols"].encode("ascii")), dtype=torch.uint8,
                       device=device)
    u = torch.rand(n, generator=gen, device=device, dtype=torch.float64)
    return lut[torch.searchsorted(cdf, u).clamp_(max=lut.numel() - 1)]


def place_items(cfg: dict, t: torch.Tensor, rng) -> None:
    """Runs and sprinkled bytes, each in a cell of its own."""
    n = t.numel()
    items = [(ord(s), int(length)) for s, length, count in cfg.get("runs", ())
             for _ in range(int(count))]
    sp = cfg.get("sprinkle")
    if sp:
        items += [(b, 1) for b in byte_values(sp["bytes"])
                  for _ in range(int(sp["count"]))]
    if not items:
        return
    cell = n // len(items)
    longest = max(length for _, length in items)
    if cell < longest:
        raise ValueError(f"{len(items)} runs and bytes do not fit {n} bytes")
    where = rng.permutation(len(items)) * cell
    where += rng.integers(0, cell - longest + 1, size=len(items))
    lengths = np.array([length for _, length in items])
    pos = np.repeat(where - np.cumsum(lengths) + lengths, lengths)
    pos += np.arange(int(lengths.sum()))
    vals = np.repeat(np.array([b for b, _ in items], np.uint8), lengths)
    t[torch.from_numpy(pos).to(t.device)] = torch.from_numpy(vals).to(t.device)


def repeat_slots(cfg: dict, n: int, rng):
    """(source start, copy start, length) of every copy: bodies of
    disjoint slots of ``length + 2`` bytes, the side bytes in the slot."""
    lengths = np.array([int(length) for length, count in cfg.get("repeats", ())
                        for _ in range(int(count))], np.int64)
    if lengths.size == 0:
        return (np.empty(0, np.int64),) * 3
    size = np.repeat(lengths + 2, 2)  # a source slot and a copy slot each
    free = n - int(size.sum())
    if free < 0:
        raise ValueError(f"repeats of {int(size.sum())} bytes exceed {n}")
    order = rng.permutation(size.size)
    cuts = np.sort(rng.integers(0, free + 1, size=size.size))
    start = np.empty(size.size, np.int64)
    start[order] = cuts + np.cumsum(size[order]) - size[order]
    pair = start.reshape(-1, 2)
    flip = rng.integers(0, 2, size=lengths.size).astype(bool)
    src = np.where(flip, pair[:, 1], pair[:, 0]) + 1
    dst = np.where(flip, pair[:, 0], pair[:, 1]) + 1
    return src, dst, lengths


def plant_repeats(cfg: dict, t: torch.Tensor, rng) -> None:
    n = t.numel()
    src, dst, lengths = repeat_slots(cfg, n, rng)
    if lengths.size == 0:
        return
    dev = t.device
    a, b = cfg["margin"].encode("ascii")
    alt = torch.full((256,), a, dtype=torch.uint8, device=dev)
    alt[a] = b
    side_src = torch.from_numpy(np.concatenate([src - 1, src + lengths])).to(dev)
    side_dst = torch.from_numpy(np.concatenate([dst - 1, dst + lengths])).to(dev)
    t[side_dst] = alt[t[side_src].long()]
    total = int(lengths.sum())
    ln = torch.from_numpy(lengths).to(dev)
    off = torch.arange(total, device=dev) - torch.repeat_interleave(
        torch.cumsum(ln, 0) - ln, ln, output_size=total)
    s = torch.repeat_interleave(torch.from_numpy(src).to(dev), ln,
                                output_size=total) + off
    d = torch.repeat_interleave(torch.from_numpy(dst).to(dev), ln,
                                output_size=total) + off
    t[d] = t[s]


def make_tensor(cfg: dict, seed: int, index: int, device) -> torch.Tensor:
    """Text ``index`` of run seed ``seed`` as a uint8 tensor on
    ``device``."""
    n = int(cfg["n_bytes"])
    rng = generator(seed, 0x7E47, index)
    gen = torch.Generator(device=device)
    gen.manual_seed(stream_seed(seed, 0x7E48, index))
    t = background(cfg, n, rng, gen, device)
    place_items(cfg, t, rng)
    plant_repeats(cfg, t, rng)
    return t


def make(cfg: dict, seed: int, index: int, device) -> bytes:
    """Text ``index`` of run seed ``seed``: ``cfg["n_bytes"]`` bytes."""
    return make_tensor(cfg, seed, index, device).cpu().numpy().tobytes()
