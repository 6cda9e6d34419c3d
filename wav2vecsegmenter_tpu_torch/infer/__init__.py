"""Batched sliding-window inference."""
