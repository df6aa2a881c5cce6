"""LM training (port of ``repro.training``): AdamW, the train steps,
checkpoints, recovery and gradient compression, over the trees of
:mod:`.tree`."""
from . import checkpoint, compression, fault_tolerance, optimizer, train_loop, tree

__all__ = ["checkpoint", "compression", "fault_tolerance", "optimizer", "train_loop",
           "tree"]
