"""Runnable examples of the port, each ``python -m
buzzdetect_torch.examples.<name>``."""
