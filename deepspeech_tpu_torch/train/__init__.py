"""Training: optimizer, train/eval steps, evaluation loop, checkpoints."""
