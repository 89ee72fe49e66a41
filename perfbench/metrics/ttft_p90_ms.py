"""ttft_p90_ms: 90th percentile, over every request due in the window, of
due time → first token; a request with no first token at the close counts
at its age then."""

from yardstick.stats import percentile


def read(run):
    due = run.due_in_window()
    if not due:
        return None
    return 1e3 * percentile([
        (r.t_first if r.t_first is not None and r.t_first <= run.t_close
         else run.t_close) - r.due for r in due], 90)
