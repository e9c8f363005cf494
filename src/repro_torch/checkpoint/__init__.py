from .index_io import IndexIOError

__all__ = ["IndexIOError"]
