"""The exchange service: collectives over a mesh of logical shards."""
