"""Generalized (multi-document) index: the first-class version of the
reference README's NUL-concatenation scheme.

    python -m suffix_torch.examples.multidoc [--device cpu]
"""

from suffix_torch import MultiDocIndex


def main(device=None) -> None:
    idx = MultiDocIndex(["the quick fox", "a lazy dog", "quick quick"],
                        device=device)
    print("'quick' occurs at (doc, offset):", sorted(idx.positions("quick")))
    print("docs containing 'quick':", idx.docs_containing("quick"))


if __name__ == "__main__":
    from suffix_torch.examples._args import device_arg

    main(device_arg(__doc__))
