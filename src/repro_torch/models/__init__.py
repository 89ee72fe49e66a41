"""Model families of the port (dense so far)."""
