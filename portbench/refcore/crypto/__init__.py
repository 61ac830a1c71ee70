"""The port's own copy of the crypto it needs outside the device path."""
