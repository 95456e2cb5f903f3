"""Training: optimizer, checkpoints, the fault-tolerant loop, steps."""
