"""Whether a value is a ``torch.distributed.tensor.DTensor``: the one test
the models, the optimizer, the runtime and the checkpoint share, in a
module that imports none of them."""
from __future__ import annotations

from torch.distributed.tensor import DTensor

__all__ = ["is_dtensor"]


def is_dtensor(x) -> bool:
    return isinstance(x, DTensor)
