"""Training: checkpoint, fault tolerance, the trainer."""
