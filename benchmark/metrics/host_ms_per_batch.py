"""Host milliseconds a batch in the extraction loop: the mean of the spans the
harness records around the session's encode call (``drivers/extract.py``,
``SessionSpy``), the time the host takes to enqueue one batch's tower."""


def read(r):
    spans = r.spans.seconds("encode")
    return 1e3 * sum(spans) / len(spans) if spans else None
