"""Host utilities of the port."""

from .sentences import split_sentences

__all__ = ["split_sentences"]
