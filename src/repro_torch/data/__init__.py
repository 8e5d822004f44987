"""Synthetic serving requests."""
