"""Synthetic data generators (host-side numpy)."""
