"""Training: schedule, optimizers, steps and the chunk loop."""
