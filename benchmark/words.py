"""English-like words on the device: Zipf-Mandelbrot words over a 32k
vocabulary with sentence, clause and paragraph structure, digits,
punctuation and a few UTF-8 words (83 distinct bytes).

The model is a copy of the port's ``utils/textgen.py`` (not imported, so
that the benchmark's inputs do not change when the program does), with
its token expansion moved to the device and its boilerplate blocks left
out: the repeats of a corpus are planted by ``corpora/repeats.py``.
"""

from __future__ import annotations

import numpy as np
import torch

VOCAB = 1 << 15

_LETTER_FREQ = np.array(
    # a      b      c      d      e      f      g      h      i
    [8.17, 1.49, 2.78, 4.25, 12.70, 2.23, 2.02, 6.09, 6.97,
     # j     k      l      m      n      o      p      q      r
     0.15, 0.77, 4.03, 2.41, 6.75, 7.51, 1.93, 0.10, 5.99,
     # s     t      u      v      w      x      y      z
     6.33, 9.06, 2.76, 0.98, 2.36, 0.15, 1.97, 0.07])


def build_vocab(rng: np.random.Generator, v: int = VOCAB):
    """(flat_bytes, starts, lens): ``v`` words, letters with English
    unigram frequencies, and digit-, punctuation- and UTF-8-bearing
    tokens in the tail ranks."""
    lens = rng.integers(1, 13, size=v).astype(np.int32)
    lens[:64] = rng.integers(1, 5, size=64)  # the Zipf head is short
    p = _LETTER_FREQ / _LETTER_FREQ.sum()
    letters = rng.choice(26, size=int(lens.sum()), p=p).astype(np.uint8) + 97
    starts = np.zeros(v, np.int64)
    starts[1:] = np.cumsum(lens)[:-1]
    words = [letters[s:s + n] for s, n in zip(starts, lens)]
    digits = np.frombuffer(b"0123456789", np.uint8)
    special = rng.permutation(np.arange(v // 4, v))[:v // 16]
    for j, i in enumerate(special):
        w = words[i]
        kind = j % 5
        if kind == 0:  # a year
            words[i] = digits[rng.integers(0, 10, size=4)]
        elif kind == 1:  # [nn], a citation
            words[i] = np.concatenate([np.frombuffer(b"[", np.uint8),
                                       digits[rng.integers(0, 10, size=2)],
                                       np.frombuffer(b"]", np.uint8)])
        elif kind == 2:  # "quoted"
            words[i] = np.concatenate([np.frombuffer(b'"', np.uint8), w,
                                       np.frombuffer(b'"', np.uint8)])
        elif kind == 3:  # hyphen-ated
            h = max(1, len(w) // 2)
            words[i] = np.concatenate([w[:h], np.frombuffer(b"-", np.uint8),
                                       w[h:]])
        else:  # two-byte UTF-8 (é à ö ...)
            acc = np.array([0xC3, 0xA9 + (j % 12)], np.uint8)
            words[i] = np.concatenate([w[:-1] if len(w) > 1 else w, acc])
    lens = np.array([len(w) for w in words], np.int64)
    starts = np.zeros(v, np.int64)
    starts[1:] = np.cumsum(lens)[:-1]
    return np.concatenate(words), starts, lens


def make(n: int, rng: np.random.Generator, gen: torch.Generator,
         device) -> torch.Tensor:
    """``n`` bytes (uint8, on ``device``) of words: the vocabulary from
    ``rng`` on the host, the token stream from ``gen`` on the device."""
    flat, starts, lens = build_vocab(rng)
    ranks = np.arange(1, VOCAB + 1, dtype=np.float64)
    probs = 1.0 / (ranks + 2.7) ** 1.07  # Zipf-Mandelbrot
    probs /= probs.sum()
    mean_token = float((probs * (lens + 1.2)).sum())  # with separators
    cdf = torch.from_numpy(np.cumsum(probs)).to(device)
    flat_d = torch.from_numpy(flat).to(device)
    starts_d = torch.from_numpy(starts).to(device)
    lens_d = torch.from_numpy(lens).to(device)
    m = int(n / mean_token * 1.08) + 64
    while True:
        u = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        ids = torch.searchsorted(cdf, u).clamp_(max=VOCAB - 1)
        u = torch.rand(m, generator=gen, device=device, dtype=torch.float64)
        end_sentence = u < 1 / 16  # ". " and a capital next
        end_clause = (u >= 1 / 16) & (u < 1 / 16 + 1 / 11)  # ", "
        end_para = u > 1 - 1 / 160  # ".\n"
        sep1 = torch.full((m,), ord(" "), dtype=torch.uint8, device=device)
        sep2 = torch.zeros(m, dtype=torch.uint8, device=device)
        sep1[end_clause] = ord(",")
        sep2[end_clause] = ord(" ")
        sep1[end_sentence | end_para] = ord(".")
        sep2[end_sentence] = ord(" ")
        sep2[end_para] = ord("\n")
        wl = lens_d[ids]
        tok_len = wl + 1 + (sep2 > 0).to(torch.int64)
        tok_start = torch.cumsum(tok_len, 0) - tok_len
        total = int(tok_start[-1] + tok_len[-1])
        if total >= n:
            break
        m *= 2
    # Byte i of token t reads flat[starts[ids[t]] + i - tok_start[t]];
    # the separator bytes read anything and are written over below.
    base = torch.repeat_interleave(starts_d[ids] - tok_start, tok_len,
                                   output_size=total)
    idx = base.add_(torch.arange(total, device=device)).clamp_(
        max=flat.size - 1)
    out = flat_d[idx]
    del base, idx
    pos1 = tok_start + wl
    out[pos1] = sep1
    has2 = sep2 > 0
    out[pos1[has2] + 1] = sep2[has2]
    cap = torch.zeros(m, dtype=torch.bool, device=device)
    cap[1:] = end_sentence[:-1] | end_para[:-1]
    cap[0] = True
    first = tok_start[cap]
    fb = out[first]
    lower = (fb >= 97) & (fb <= 122)
    out[first[lower]] = fb[lower] - 32
    return out[:n].contiguous()
