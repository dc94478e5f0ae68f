"""Host milliseconds a split after its last batch with nothing queued on the
card: the mean self time of the program's ``extract.gather`` spans outside
their ``extract.fetch`` child (``apps/common.extract_image_features``: the
concat and the metadata enqueued, then, once the blocking copy to the host has
returned, the mask and the sort on the host)."""

from benchmark import program_spans


def read(r):
    rec = program_spans.recorded(r)
    spans = (program_spans.self_seconds(rec, "extract.gather", "extract.fetch")
             if rec is not None else [])
    return 1e3 * sum(spans) / len(spans) if spans else None
