"""Host milliseconds a CLIP-search pass in the cache selection: the program's
``search.select`` spans (``apps/image_attention.ImageAttention.build_cache``:
the selection and its host gather, the pseudo-labels' accuracies) over its
``search.passes`` counter."""

from benchmark import program_spans


def read(r):
    rec = program_spans.recorded(r)
    if rec is None:
        return None
    passes = rec.counters.get("search.passes", 0)
    spans = program_spans.seconds(rec, "search.select")
    return 1e3 * sum(spans) / passes if passes and spans else None
