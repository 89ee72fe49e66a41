"""ttft_p90_ms.batch: ``ttft_p90_ms`` in the closed-loop batch cell, where
a batch's requests are due when it starts; a metric apart, since it
spreads a hundred times less than the open-loop cells' tails."""

from yardstick.cell import reader

read = reader("ttft_p90_ms")
