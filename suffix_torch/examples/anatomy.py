"""Anatomy of a suffix table: the reference's examples/anatomy.rs.

    python -m suffix_torch.examples.anatomy [--device cpu]
"""

from suffix_torch import SuffixTable


def main(device=None) -> None:
    st = SuffixTable.new("the quick brown fox was quick.", device=device)
    print(st)  # full rank/sufstart/suffix dump, like the reference Debug impl

    result = st.positions("quick")
    print("search result:", result.tolist())
    assert sorted(result.tolist()) == [4, 24]
    for i in result:
        print(f"quick found! Starts at index: {i}")


if __name__ == "__main__":
    from suffix_torch.examples._args import device_arg

    main(device_arg(__doc__))
