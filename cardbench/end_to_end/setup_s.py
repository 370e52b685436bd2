"""setup_s: seconds from the process's start to the window's: imports,
the card's start, kernel builds or loads, the deployment's fixed parts,
keygen and the warm-up on the cell's own shapes."""


def read(record):
    return record.setup_s
