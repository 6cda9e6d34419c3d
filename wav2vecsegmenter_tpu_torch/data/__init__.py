"""Inference windows and static-shape batches."""
