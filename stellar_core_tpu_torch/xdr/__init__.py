"""The port's own copy of the XDR types it reads (no codec yet)."""
