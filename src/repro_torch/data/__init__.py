"""Synthetic data (numpy, as the reference's)."""
