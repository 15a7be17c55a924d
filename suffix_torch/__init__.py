"""suffix_torch — the PyTorch / CUDA port of suffix_tpu for NVIDIA Hopper.

Same contract as ``suffix_tpu`` (suffix tables, substring queries), same
outputs bit for bit. Entry points run on CUDA unless the caller passes
``device="cpu"``. The package imports neither JAX nor ``suffix_tpu``.
"""

from suffix_torch.table import SuffixTable

__all__ = ["SuffixTable"]
