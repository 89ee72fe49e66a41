"""Shared arithmetic of the port (its own copy of ``repro.core`` helpers)."""
