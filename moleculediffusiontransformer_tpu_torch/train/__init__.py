"""Optimizer and train step of the port."""
