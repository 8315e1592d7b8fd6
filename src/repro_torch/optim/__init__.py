"""Optimizers for training."""
