"""Diffusion objective, schedule and sampler of the port."""
