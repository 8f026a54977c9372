"""Training: optimiser, steps, metrics, per-video aggregation, agents."""
