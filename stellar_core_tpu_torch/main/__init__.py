"""Application layer (reference: src/main/): so far the node's
configuration and the catchup subcommands of its command line."""

from .config import Config, HistoryArchiveConfig

__all__ = ["Config", "HistoryArchiveConfig"]
