"""TPC-H and ClickBench data generators, TPC-H plans and SQL text."""
