"""Dense transformer layers and serving forwards."""
