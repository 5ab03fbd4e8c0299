"""Checkpoints and the distributed control plane (no device code)."""
