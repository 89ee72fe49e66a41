"""device_idle_share.batch: ``device_idle_share`` in the closed-loop batch
cell, where it moves ``out_tokens_per_s.batch``."""

from yardstick.cell import reader

read = reader("device_idle_share")
