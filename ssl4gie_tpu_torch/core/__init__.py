"""Optimizer and train step."""
