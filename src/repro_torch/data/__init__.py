"""TPC-H data generator and hand-built query plans."""
