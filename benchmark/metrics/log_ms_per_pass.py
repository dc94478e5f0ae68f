"""Host milliseconds a CLIP-search pass in logging its records: the program's
``search.log`` spans (``apps/image_attention.ImageAttention._log_results``: a
beta's records, one an alpha) over its ``search.passes`` counter."""

from benchmark import program_spans


def read(r):
    rec = program_spans.recorded(r)
    if rec is None:
        return None
    passes = rec.counters.get("search.passes", 0)
    spans = program_spans.seconds(rec, "search.log")
    return 1e3 * sum(spans) / passes if passes and spans else None
