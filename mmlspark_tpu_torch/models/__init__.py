"""Models of the port (GBDT so far)."""
