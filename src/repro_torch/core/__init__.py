"""Packed BFP formats, quantizers and policies (counterpart of ``repro.core``)."""
