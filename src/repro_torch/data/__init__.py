"""The deterministic synthetic data pipeline of LM training."""
