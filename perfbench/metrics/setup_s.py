"""setup_s: process start to the first timed job: imports, drawing the
pool, loading the kernel library (building it on a first run), one
warm-up job on the largest pool graph."""


def read(record):
    return record["setup_s"]
