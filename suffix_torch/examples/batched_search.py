"""Thousands of patterns in one device dispatch.

    python -m suffix_torch.examples.batched_search [--device cpu]
"""

import numpy as np

from suffix_torch import SuffixTable


def main(device=None) -> int:
    rng = np.random.default_rng(0)
    text = rng.integers(0, 4, size=1 << 16, dtype=np.uint8) + ord("a")
    st = SuffixTable.new(text.tobytes(), device=device)

    patterns = [text[i : i + 8].tobytes() for i in range(0, 4096, 16)]
    counts = st.count_batch(patterns)
    total = int(counts.sum())
    print(f"{len(patterns)} patterns, total occurrences: {total}")
    return total


if __name__ == "__main__":
    from suffix_torch.examples._args import device_arg

    main(device_arg(__doc__))
