"""Model inventories for the paper's accounting (port of ``benchmarks``)."""
