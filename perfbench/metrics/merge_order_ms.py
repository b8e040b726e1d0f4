"""merge_order_ms: per job, the program's ``merge.order`` span: the
recorded edges found, put in merge order by one stable argsort, and their
endpoints gathered to Python lists."""
from perfbench import program_spans


def read(record):
    return program_spans.per_job_ms(record, "merge.order")
