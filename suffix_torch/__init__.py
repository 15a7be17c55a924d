"""suffix_torch — the PyTorch / CUDA port of suffix_tpu for NVIDIA Hopper.

Same contract as ``suffix_tpu`` (suffix tables, substring queries,
multi-document indexes, suffix trees, the CLI and the serving runtime),
same outputs bit for bit. Entry points run on CUDA unless the caller
passes ``device="cpu"``. The package imports neither JAX nor
``suffix_tpu``.
"""

from suffix_torch.table import SuffixTable
from suffix_torch.multidoc import MultiDocIndex
from suffix_torch.tree.stree import SuffixTree
from suffix_torch.tree.atree import ArraySuffixTree

__all__ = ["SuffixTable", "MultiDocIndex", "SuffixTree", "ArraySuffixTree"]
