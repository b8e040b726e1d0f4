"""merge_greedy_ms: per job, the program's ``merge.greedy`` span: the
Python loop of the greedy merge over the recorded edges."""
from perfbench import program_spans


def read(record):
    return program_spans.per_job_ms(record, "merge.greedy")
