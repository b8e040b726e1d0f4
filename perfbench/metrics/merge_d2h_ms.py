"""merge_d2h_ms: per job, the program's ``merge.d2h`` span: Part 1's
``assigned`` copied to the host for the merge."""
from perfbench import program_spans


def read(record):
    return program_spans.per_job_ms(record, "merge.d2h")
