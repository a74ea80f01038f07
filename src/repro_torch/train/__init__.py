"""Training: the compressed train step, its accumulators, the
fault-tolerant loop and the recsys setup of the training CLI."""
