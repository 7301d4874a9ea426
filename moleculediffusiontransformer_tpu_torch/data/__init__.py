"""The port's own copies of the JAX package's data modules (tokenizer,
scaler and metrics, QM9 preparation), numpy only."""
