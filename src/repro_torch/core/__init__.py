"""Plan IR, pipeline executor and the kernel backend."""
