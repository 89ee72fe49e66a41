"""Serving of the port: request scheduler, paged KV cache, engines."""
