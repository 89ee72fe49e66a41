"""Roofline arithmetic of the port (``analysis``)."""
