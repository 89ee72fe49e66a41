"""paged_decode_roofline.rag: ``paged_decode_roofline`` in the cell that
reports TTFT and no token gap, where the decode steps K14 shortens sit
between a request's arrival and its prefill."""

from yardstick.cell import reader

read = reader("paged_decode_roofline")
