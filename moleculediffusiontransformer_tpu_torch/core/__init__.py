"""Configuration, checkpoints and small helpers of the port."""
