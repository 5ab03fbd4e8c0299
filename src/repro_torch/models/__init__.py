"""LM stack of the port (dense family) — counterpart of ``repro/models``."""
