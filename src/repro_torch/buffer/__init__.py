"""Device buffer manager (caching and processing regions)."""
