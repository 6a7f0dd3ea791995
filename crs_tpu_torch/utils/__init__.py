"""Host utilities of the port."""

from .config import ConfigLoader
from .logging_setup import setup_logging
from .sentences import split_sentences

__all__ = ["ConfigLoader", "setup_logging", "split_sentences"]
