"""Data substrate of the port (counterpart of ``repro.data``)."""
from .pipeline import SyntheticLM, make_batch_iterator

__all__ = ["SyntheticLM", "make_batch_iterator"]
