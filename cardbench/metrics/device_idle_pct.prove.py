"""device_idle_pct.prove: the share of the traced window in which no
operation ran on the device, in percent."""


def read(record):
    t = record.tracer
    if t.busy is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
