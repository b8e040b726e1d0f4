"""h2d_ms: per job, the program's ``stream.to`` spans that copy the stream
from host memory to the device (the H2D from pinned memory, synchronised
at the span's end)."""
from perfbench import program_spans


def read(record):
    return program_spans.per_job_ms(
        record, "stream.to", keep=lambda args: str(args.get("source", "")).startswith("cpu"))
