"""Basic usage: the reference's examples/basic.rs as Python.

    python -m suffix_torch.examples.basic [--device cpu]
"""

from suffix_torch import SuffixTable


def main(device=None) -> None:
    st = SuffixTable.new("the quick brown fox was quick.", device=device)
    assert st.positions("quick").tolist() == [4, 24]
    print("positions of 'quick':", st.positions("quick").tolist())


if __name__ == "__main__":
    from suffix_torch.examples._args import device_arg

    main(device_arg(__doc__))
