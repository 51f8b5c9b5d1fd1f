"""Synthetic input data."""
