"""Synthetic data: the training corpus and the serving requests."""
