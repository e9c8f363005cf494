from .checkpointer import Checkpointer
from .index_io import IndexIOError

__all__ = ["Checkpointer", "IndexIOError"]
