"""Training: loss, train step and the fault-tolerant loop."""
