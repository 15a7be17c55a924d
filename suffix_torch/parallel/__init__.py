"""Sharded construction over a ``torch.distributed`` process group."""
