"""device_idle_share: 1 − (the union of the device's operation intervals
÷ the traced slice), in %."""


def read(run):
    if run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)
