"""Training — counterpart of ``repro/training``: AdamW with the reference's
schedule and decay rule, int8 gradient compression with error feedback,
and the train step of every configuration."""
