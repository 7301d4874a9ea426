"""Neural-network modules of the port, channels-last (b, L, C)."""
