"""Optimizer: AdamW with clipping and int8 error feedback, LR schedules."""
