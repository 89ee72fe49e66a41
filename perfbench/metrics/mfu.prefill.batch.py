"""mfu.prefill.batch: ``mfu.prefill`` in the closed-loop batch cell (the
prefill timed by ``ServeStats.ttft_s``), beside the scan's roofline that
moves ``ttft_p90_ms.batch``."""

from yardstick.cell import reader

read = reader("mfu.prefill")
