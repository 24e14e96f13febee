"""Training: masks, the train step and loop, checkpoints."""
