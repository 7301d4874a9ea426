"""Task-layer models of the port."""
