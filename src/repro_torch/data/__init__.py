"""Data: the deterministic token pipeline."""
