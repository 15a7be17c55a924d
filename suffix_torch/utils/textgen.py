"""Synthetic natural-language-class corpora, a copy of
``suffix_tpu/utils/textgen.py`` (numpy only), so that the port generates the
JAX package's benchmark text byte for byte without importing it.

An enwik8-class corpus, fully determined by the seed:

- Zipf-Mandelbrot word frequencies over a ~32k-word vocabulary
  (rank^-1.07, the empirical law for English);
- sentence and paragraph structure: capitalization, '.', ',', newlines;
- digits, punctuation-bearing tokens and a few UTF-8 multibyte words push
  the byte alphabet past 64 symbols;
- repeated multi-kB boilerplate blocks (the analogue of enwik8's templates),
  which exercise the deep-LCP survivor paths and long-pattern queries.
"""

from __future__ import annotations

import numpy as np

_LETTER_FREQ = np.array(
    # a      b      c      d      e      f      g      h      i
    [8.17, 1.49, 2.78, 4.25, 12.70, 2.23, 2.02, 6.09, 6.97,
     # j     k      l      m      n      o      p      q      r
     0.15, 0.77, 4.03, 2.41, 6.75, 7.51, 1.93, 0.10, 5.99,
     # s     t      u      v      w      x      y      z
     6.33, 9.06, 2.76, 0.98, 2.36, 0.15, 1.97, 0.07])


def _build_vocab(rng: np.random.Generator, v: int):
    """(flat_bytes, starts, lens): v words — letters with English
    unigram frequencies, plus digit-, punctuation- and UTF-8-bearing
    tokens in the tail ranks (markup-like diversity)."""
    lens = rng.integers(1, 13, size=v).astype(np.int32)
    # Bias toward short high-rank words (the Zipf head is "the/of/and").
    lens[:64] = rng.integers(1, 5, size=64)
    p = _LETTER_FREQ / _LETTER_FREQ.sum()
    total = int(lens.sum())
    letters = rng.choice(26, size=total, p=p).astype(np.uint8) + 97
    starts = np.zeros(v, np.int32)
    starts[1:] = np.cumsum(lens)[:-1]
    words = [letters[s:s + l] for s, l in zip(starts, lens)]
    # Tail-rank special tokens: numbers, bracketed refs, quoted words,
    # hyphenations, a few UTF-8 (Latin-1 supplement) words.
    n_special = v // 16
    special_idx = rng.permutation(np.arange(v // 4, v))[:n_special]
    digits = np.frombuffer(b"0123456789", np.uint8)
    for j, i in enumerate(special_idx):
        w = words[i]
        kind = j % 5
        if kind == 0:  # year-like number
            words[i] = digits[rng.integers(0, 10, size=4)]
        elif kind == 1:  # [n] citation
            words[i] = np.concatenate(
                [np.frombuffer(b"[", np.uint8),
                 digits[rng.integers(0, 10, size=2)],
                 np.frombuffer(b"]", np.uint8)])
        elif kind == 2:  # "quoted"
            words[i] = np.concatenate(
                [np.frombuffer(b'"', np.uint8), w,
                 np.frombuffer(b'"', np.uint8)])
        elif kind == 3:  # hyphen-ated
            h = max(1, len(w) // 2)
            words[i] = np.concatenate(
                [w[:h], np.frombuffer(b"-", np.uint8), w[h:]])
        else:  # UTF-8 multibyte (é à ö ...)
            acc = np.array([0xC3, 0xA9 + (j % 12)], np.uint8)
            words[i] = np.concatenate([w[:-1] if len(w) > 1 else w, acc])
    lens = np.array([len(w) for w in words], np.int32)
    starts = np.zeros(v, np.int32)
    starts[1:] = np.cumsum(lens)[:-1]
    return np.concatenate(words), starts, lens


def text_corpus(n_bytes: int, seed: int = 0x3E77,
                boilerplate_bytes: int = 4096,
                boilerplate_copies: int = 40) -> np.ndarray:
    """Deterministic enwik8-class corpus of exactly ``n_bytes`` (uint8).

    ``boilerplate_copies`` exact duplicates of a ``boilerplate_bytes``
    slice are spliced in at random points (0 disables), bounding the
    corpus' max LCP from below by ~boilerplate_bytes.
    """
    rng = np.random.default_rng(seed)
    v = 1 << 15
    flat, starts, lens = _build_vocab(rng, v)

    # Zipf-Mandelbrot ranks: p(r) ~ 1/(r + beta)^alpha.
    ranks = np.arange(1, v + 1, dtype=np.float64)
    probs = 1.0 / (ranks + 2.7) ** 1.07
    probs /= probs.sum()
    mean_token = float((probs * (lens + 1.2)).sum())  # + separator cost
    m = int(n_bytes / mean_token * 1.08) + 16
    ids = rng.choice(v, size=m, p=probs).astype(np.int32)

    # Sentence / clause / paragraph structure (per-token separators).
    u = rng.random(m)
    end_sentence = u < 1 / 16          # ". " + capitalize next
    end_clause = (u >= 1 / 16) & (u < 1 / 16 + 1 / 11)   # ", "
    end_para = u > 1 - 1 / 160         # ".\n\n"-ish (2-byte budget: ".\n")
    sep1 = np.full(m, ord(" "), np.uint8)
    sep2 = np.zeros(m, np.uint8)  # 0 = no second separator byte
    sep1[end_clause] = ord(",")
    sep2[end_clause] = ord(" ")
    sep1[end_sentence] = ord(".")
    sep2[end_sentence] = ord(" ")
    sep1[end_para] = ord(".")
    sep2[end_para] = ord("\n")

    tok_len = lens[ids] + 1 + (sep2 > 0).astype(np.int32)
    out_len = int(tok_len.sum())
    tok_start = np.zeros(m, np.int64)
    tok_start[1:] = np.cumsum(tok_len[:-1])
    # Per-byte expansion as ONE vocab gather: byte i of token t reads
    # flat[starts[ids[t]] + (i - tok_start[t])]. The per-byte base array
    # is np.repeat(starts[ids] - tok_start, tok_len), built as a delta
    # scatter + cumsum (np.repeat itself measures ~5x slower than the
    # two passes on this host). Separator bytes get garbage gathers and
    # are overwritten by position scatters below — every non-word byte
    # IS a separator byte by construction of tok_len.
    base = starts[ids].astype(np.int64) - tok_start
    delta = np.zeros(out_len, np.int64)
    delta[0] = base[0]
    delta[tok_start[1:]] = np.diff(base)
    idx = np.cumsum(delta) + np.arange(out_len, dtype=np.int64)
    out = flat[np.minimum(idx, flat.size - 1)]
    pos1 = tok_start + lens[ids]  # the sep1 byte of every token
    out[pos1] = sep1
    has2 = sep2 > 0
    out[pos1[has2] + 1] = sep2[has2]
    # Capitalize sentence-initial words (uppercase doubles the letter
    # alphabet, like real prose).
    cap = np.zeros(m, bool)
    cap[1:] = end_sentence[:-1] | end_para[:-1]
    cap[0] = True
    first_byte = tok_start[cap]
    fb = out[first_byte]
    is_lower = (fb >= 97) & (fb <= 122)
    out[first_byte[is_lower]] = fb[is_lower] - 32

    out = out[:n_bytes].astype(np.uint8)
    if boilerplate_copies and n_bytes > 4 * boilerplate_bytes:
        # Exact multi-kB duplicates (template/license boilerplate): the
        # deep-LCP tail real text has and DNA benchmarks hide.
        src = int(rng.integers(0, n_bytes - boilerplate_bytes))
        block = out[src:src + boilerplate_bytes].copy()
        at = np.sort(rng.integers(0, n_bytes,
                                  size=boilerplate_copies)).astype(np.int64)
        pieces, prev = [], 0
        for a in at:
            pieces.append(out[prev:a])
            pieces.append(block)
            prev = a
        pieces.append(out[prev:])
        out = np.concatenate(pieces)[:n_bytes]
    return out


def corpus_stats(arr: np.ndarray) -> dict:
    """sigma + byte-entropy summary for honest benchmark labeling."""
    counts = np.bincount(arr, minlength=256)
    p = counts[counts > 0] / arr.size
    return {
        "n": int(arr.size),
        "sigma": int((counts > 0).sum()),
        "entropy_bits_per_byte": round(float(-(p * np.log2(p)).sum()), 3),
    }
