"""train subpackage: optimizers, the training step, disk and erasure-coded
in-memory checkpoints."""
