"""Runnable examples of the port, the counterparts of ``examples/``:
``python -m suffix_torch.examples.basic [--device cpu]``."""
