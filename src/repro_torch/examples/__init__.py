"""The port's runnable examples: ``python -m repro_torch.examples.<name>``."""
