"""Application layer (reference: src/main/)."""
