"""Durable storage layer (reference: src/database/)."""

from .database import Database, PersistentState, SCHEMA_VERSION

__all__ = ["Database", "PersistentState", "SCHEMA_VERSION"]
