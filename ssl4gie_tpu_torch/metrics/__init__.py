"""Losses and metrics."""
