"""out_tokens_per_s.batch: ``out_tokens_per_s`` in the closed-loop batch
cell; a metric apart, since its host-paced decode steps spread it
several times more than the open-loop cells' rate."""

from yardstick.cell import reader

read = reader("out_tokens_per_s")
