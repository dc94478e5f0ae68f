"""The port's recorder of spans and counters (``core/profiling``): off, it
records and allocates nothing; on under a profiler or ``recording()``, with
each span's parent on its own thread; the spans and counts of the extraction
loop, the Tip search and a CLIP-search pass; a device span's time on the card
(``cuda``)."""

import threading
import tracemalloc

import numpy as np
import pytest
import torch

from summer_clip_torch.core import profiling


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _names(rec):
    return [n for n, _, _ in rec.items]


def _parent(rec, i):
    p = rec.parents[i]
    return rec.items[p][0] if p >= 0 else None


def test_off_records_nothing_and_allocates_nothing(monkeypatch):
    made = []
    monkeypatch.setattr(torch.cuda, "Event", lambda *a, **k: made.append(1))
    x = torch.zeros(2)
    assert profiling.span("a") is profiling.span("b", device=x)   # one shared object
    tracemalloc.start()
    try:
        base = tracemalloc.get_traced_memory()[0]
        for _ in range(10_000):
            with profiling.span("a", device=x):
                profiling.count("n", 3)
        grown = tracemalloc.get_traced_memory()[0] - base
    finally:
        tracemalloc.stop()
    assert grown < 1024
    rec = profiling.recorded()
    assert rec.items == [] and rec.counters == {} and not made


def test_on_under_a_profiler_and_recording(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span("outer"):
            with profiling.span("inner", device=torch.zeros(1)):   # not on a card: no events
                pass
            with profiling.span("inner"):
                pass
        seen = []
        t = threading.Thread(target=lambda: seen.append(profiling.span("x") is profiling.span("y")))
        t.start()
        t.join(timeout=10)
        assert not t.is_alive() and seen == [True]       # the profiler's flag is per thread
    rec = profiling.recorded()
    assert _names(rec) == ["outer", "inner", "inner"]
    assert rec.parents == [-1, 0, 0] and rec.device_ms == [None] * 3
    assert all(t0 <= t1 for _, t0, t1 in rec.items)
    assert rec.items[0][1] <= rec.items[1][1] and rec.items[2][2] <= rec.items[0][2]

    profiling.reset()
    barrier = threading.Barrier(2)

    def work(tag):
        with profiling.span(f"{tag}.a"):
            barrier.wait(timeout=10)        # both threads hold a span open at once
            with profiling.span(f"{tag}.b"):
                barrier.wait(timeout=10)

    with profiling.recording():
        threads = [threading.Thread(target=work, args=(tag,)) for tag in ("p", "q")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    rec = profiling.recorded()
    assert sorted(_names(rec)) == ["p.a", "p.b", "q.a", "q.b"]
    for i, name in enumerate(_names(rec)):
        if name.endswith(".b"):
            assert _parent(rec, i) == name[0] + ".a"
            assert rec.threads[i] == rec.threads[rec.parents[i]]
        else:
            assert rec.parents[i] == -1
    with profiling.span("after"):          # recording is off again
        pass
    assert len(profiling.recorded().items) == 4

    monkeypatch.setattr(profiling, "MAX_SPANS", 5)
    with profiling.recording():
        for _ in range(3):                 # one recorded, two past the cap
            with profiling.span("late"):
                pass
    rec = profiling.recorded()
    assert len(rec.items) == 5 and rec.dropped == 2


def test_counters_add_up():
    with profiling.recording():
        for n in (1, 2, 3.5):
            profiling.count("a", n)
        profiling.count("b")
        threads = [threading.Thread(target=lambda: [profiling.count("c") for _ in range(500)])
                   for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
    profiling.count("a", 100)             # off
    assert profiling.recorded().counters == {"a": 6.5, "b": 1, "c": 2000}


def test_extraction_spans_and_counts():
    from summer_clip_torch.apps.common import create_clip_session, extract_image_features
    from summer_clip_torch.data.loader import Batch

    session = create_clip_session("test-vit", device="cpu")
    rng = np.random.default_rng(0)
    batches = [Batch(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8), np.zeros(4, np.int32),
                     np.arange(4 * i, 4 * i + 4, dtype=np.int32), np.array([1, 1, 1, i < 2], bool))
               for i in range(3)]
    with profiling.recording():
        feats, _, _ = extract_image_features(session, batches)
    rec = profiling.recorded()
    names = _names(rec)
    assert feats.shape[0] == 11
    assert {n: names.count(n) for n in set(names)} == {
        "extract": 1, "extract.load": 4, "extract.stage": 3, "extract.encode": 3,
        "tower.image": 3, "block.attn": 6, "block.mlp": 6, "extract.gather": 1,
        "extract.fetch": 1}
    assert rec.counters == {"extract.batches": 3, "extract.images": 11, "tower.blocks": 6}
    want = {"extract.load": "extract", "extract.stage": "extract", "extract.encode": "extract",
            "tower.image": "extract.encode", "block.attn": "tower.image",
            "block.mlp": "tower.image", "extract.gather": "extract",
            "extract.fetch": "extract.gather", "extract": None}
    assert all(_parent(rec, i) == want[n] for i, n in enumerate(names))


def test_tip_search_spans_and_points():
    from summer_clip_torch.methods.tip import search_hp

    rng = np.random.default_rng(1)
    feats = rng.standard_normal((12, 8)).astype(np.float32)
    keys = rng.standard_normal((6, 8)).astype(np.float32)
    values = np.eye(3, dtype=np.float32)[np.arange(6) % 3]
    with profiling.recording():
        search_hp(feats, np.arange(12) % 3, rng.standard_normal((12, 3)).astype(np.float32),
                  keys, values, search_step=(5, 3), beta_chunk=2, device="cpu")
    rec = profiling.recorded()
    assert rec.counters == {"tip.searches": 1, "tip.chunks": 3, "tip.betas": 5, "tip.blended": 5,
                            "tip.points": 15}
    names = _names(rec)
    assert names.count("tip.cache") == names.count("tip.blend") == names.count("tip.fetch") == 3
    assert all(_parent(rec, i) == {"tip.search": None, "tip.cache": "tip.search",
                                   "tip.blend": "tip.search", "tip.fetch": "tip.blend"}[n]
               for i, n in enumerate(names))


def test_clip_search_pass_spans_and_points(tmp_path):
    from benchmark import harness
    from benchmark.tests import tiny

    ctx = tiny.context("vitl14.clip_search", tmp_path)
    drv = harness.driver("clip_search")
    st = drv.setup(ctx)
    try:
        with profiling.recording():
            st.app.train_loop()
    finally:
        drv.release(ctx, st)
    rec = profiling.recorded()
    t = ctx.workload["traffic"]
    values, chunks = len(t["value_scales"]), -(-len(t["betas"]) // 8)
    assert rec.counters == {"search.passes": 1, "search.cache_calls": values * chunks,
                            "search.points": drv.points_per_pass(ctx)}
    names = _names(rec)
    assert {n: names.count(n) for n in set(names)} == {
        "search.pass": 1, "search.zero_shot": 1, "search.select": 1, "search.values": values,
        "search.cache": values * chunks, "search.evaluate": values * chunks,
        "search.fetch": values * chunks, "search.log": values * len(t["betas"])}
    assert all(_parent(rec, i) == ("search.evaluate" if n == "search.fetch" else
                                   None if n == "search.pass" else "search.pass")
               for i, n in enumerate(names))


def test_idle_gap_named_by_the_innermost_program_span():
    from benchmark import devtrace
    from benchmark.devtrace import DeviceEvent

    with profiling.recording():
        with profiling.span("outer"):
            with profiling.span("inner"):
                pass
    items = profiling.recorded().items
    (_, o0, o1), (_, i0, i1) = items
    events = [DeviceEvent("void k(int)", o0 - 50, i0 + 1), DeviceEvent("void k(int)", o1, o1 + 9)]
    assert devtrace.idle_gaps(events, items, offset_ns=0)[0][0] == "host in inner"


def test_card_events_read_in_order_and_reused(monkeypatch):
    """A card's events as ``core/profiling`` keeps them, with a stand-in event
    whose card clock the test moves: each time is the distance from the first
    event, events are read only once completed, and about ``PENDING`` are
    alive at a time."""
    class Card:
        now, done = 0.0, -1.0

    class Event:
        made = 0

        def __init__(self, enable_timing):
            assert enable_timing
            Event.made += 1

        def record(self, stream):
            self.at = stream.now

        def query(self):
            return self.at <= Card.done

        def elapsed_time(self, other):
            return other.at - self.at

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda card: None)
    rec, marks = profiling._REC, []
    for k in range(1000):
        Card.now = 1000.0 + 0.25 * k
        marks.append(rec.mark(0, Card))
        if k % 100 == 99:
            Card.done = Card.now - 30.0       # the card runs behind the host
        assert len(rec.cards[0].pending) <= profiling.PENDING + 1
    Card.done = Card.now
    profiling.recorded()
    assert [rec.mark_ms[m] for m in marks] == [0.25 * k for k in range(1000)]
    assert Event.made <= profiling.PENDING + 3


@pytest.mark.cuda
def test_device_spans_time_the_card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: device spans time CUDA events")
    made = []
    event = torch.cuda.Event

    def counted(*args, **kwargs):
        made.append(1)
        return event(*args, **kwargs)

    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    b = torch.randn(2048, 2048, device="cuda", dtype=torch.bfloat16)
    for _ in range(3):
        a @ a, b @ b
    torch.cuda.synchronize()
    monkeypatch.setattr(torch.cuda, "Event", counted)
    outer0, outer1 = event(enable_timing=True), event(enable_timing=True)
    with profiling.recording():
        outer0.record()
        for k in range(200):
            with profiling.span("big", device=a):
                for _ in range(2):
                    a @ a
            with profiling.span("small", device=b):
                b @ b
            if k == 150:     # 303 events wait, past PENDING: the next spans reuse them
                torch.cuda.synchronize()
        outer1.record()
    rec = profiling.recorded()
    assert profiling.PENDING < 303 and len(made) < 320   # one event a span plus one, reused
    big = [ms for (n, _, _), ms in zip(rec.items, rec.device_ms) if n == "big"]
    small = [ms for (n, _, _), ms in zip(rec.items, rec.device_ms) if n == "small"]
    assert len(big) == len(small) == 200 and min(big) > 4 * max(small) > 0
    total = outer0.elapsed_time(outer1)
    assert abs(sum(big) + sum(small) - total) <= 0.05 * total
