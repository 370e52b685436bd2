"""proofs_per_hour: 3600 x the proofs the window completed over the
seconds from its start to the end of its last proof (one client, back to
back)."""


def read(record):
    w = record.window
    return 3600.0 * len(w.served) / (w.t_end - w.t0)
