"""Token data for training."""
