"""Lowering decisions of the port (``LoweringConfig``, ``lower``)."""

from repro_torch.compile.config import (VALID_BACKENDS, Lowering,
                                        LoweringConfig, lower)

__all__ = ["VALID_BACKENDS", "Lowering", "LoweringConfig", "lower"]
