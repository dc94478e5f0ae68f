"""Host milliseconds a batch to stage it for the card: the mean of the
program's ``extract.stage`` spans (``data/prefetch.to_device``: the batch made
contiguous, copied into pinned memory, its non-blocking copy enqueued)."""

from benchmark import program_spans


def read(r):
    rec = program_spans.recorded(r)
    spans = program_spans.seconds(rec, "extract.stage") if rec is not None else []
    return 1e3 * sum(spans) / len(spans) if spans else None
