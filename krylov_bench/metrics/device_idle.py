"""``device_idle`` (layer: device), %: the share of the traced solves' time
in which no device operation ran.  Busy time and window come from the same
solves, traced with the device's activity alone (``device.busy_s`` and
``device.window_s``), so the profiler records none of the host's work
that sets a host-paced solve's pace."""


def read(run):
    if not run.device_window_s:
        return None
    return 100.0 * (1.0 - run.device_busy_s / run.device_window_s)
