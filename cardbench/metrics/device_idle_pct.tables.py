"""device_idle_pct.tables: the share of the traced window in which no
operation ran on the device, in percent."""


def read(record):
    t = record.tracer
    if t is None or t.busy is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
