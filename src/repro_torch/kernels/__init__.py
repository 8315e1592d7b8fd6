"""Fused dequant-matmul kernel, its plain version and the dispatch."""
