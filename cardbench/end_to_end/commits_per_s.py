"""commits_per_s: the commitments the window completed over the seconds the
program spent serving them, the sum of the commits' spans (one client, back
to back; the client draws each request's coefficients between spans, and
that time is the benchmark's, not the program's)."""


def read(record):
    w = record.window
    return len(w.served) / sum(end - start for start, end in w.spans)
