"""Measurement tools for the port's kernels on the card."""
