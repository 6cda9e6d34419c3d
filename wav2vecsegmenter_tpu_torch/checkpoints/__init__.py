"""Checkpoint loading: reference .pt files and JAX parameter trees."""
