"""Training: the Trainer loop, the optimizer, evaluation, metrics and
checkpoints."""
