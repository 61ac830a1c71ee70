"""The port's own copy of the herder code the quorum checker needs."""
