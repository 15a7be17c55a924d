from suffix_torch.tree.stree import SuffixTree, Node
from suffix_torch.tree.dot import to_dot

__all__ = ["SuffixTree", "Node", "to_dot"]
