"""Models of the port (FM in this slice)."""
