"""``summer_clip_torch.engine.serving`` and the megakernel samplers against the JAX package.

The engine's contract: iteration-level batching with mid-stream admission and
slot reuse must not change any request's output. So each mode of the port's
``ContinuousBatcher`` (per-step, burst, chained bursts, wave, deferred drain,
token-wise prefill, eot, the megakernel arm) is held, request by request, to the
JAX package's solo sampler on weights carried across and to the port's own solo
sampler; the megakernel engine also to the JAX engine itself. Greedy ids are
compared exactly: at these sizes a row's arithmetic on the CPU does not depend
on its companions. ``generate_device`` / ``generate_device_batched`` with
``megakernel=True`` are held to the JAX package's (whose K8 runs in interpret
mode). The ``cuda`` case runs the megakernel engine on the card.
"""

import numpy as np
import pytest
import torch

from summer_clip_torch.apps import gen_gpt as tgen
from summer_clip_torch.engine.quant import quantize_tree
from summer_clip_torch.engine.serving import ContinuousBatcher
from summer_clip_torch.ops import decode_block as DB
from tests.test_torch_gen_gpt import make_pair


class _Side:
    """One pair of models and memoised solo oracles of both packages."""

    def __init__(self, config: str, quant: bool, megakernel: bool = False):
        self.jm, self.jv, tm = make_pair("clip_gpt", config, quant=quant)
        self.tm = tm
        self.kw = dict(top_k=1, quant_int8=quant, megakernel=megakernel)
        self.vocab = 300
        self._jax, self._torch = {}, {}

    def jax(self, prompt, max_new, eot_id=None):
        from summer_clip_tpu.apps import gen_gpt as jgen

        key = (tuple(prompt), max_new, eot_id)
        if key not in self._jax:
            self._jax[key] = jgen.generate_device(self.jm, self.jv, list(prompt),
                                                  max_new_tokens=max_new, eot_id=eot_id,
                                                  **self.kw)[len(prompt):]
        return self._jax[key]

    def torch(self, prompt, max_new, eot_id=None):
        key = (tuple(prompt), max_new, eot_id)
        if key not in self._torch:
            self._torch[key] = tgen.generate_device(self.tm, list(prompt), max_new_tokens=max_new,
                                                    eot_id=eot_id, **self.kw)[len(prompt):]
        return self._torch[key]

    def check(self, reqs, prompts, eot_id=None):
        for r, p in zip(reqs, prompts):
            assert r.done
            assert r.out_ids == self.jax(p, r.max_new_tokens, eot_id), ("jax", p)
            assert r.out_ids == self.torch(p, r.max_new_tokens, eot_id), ("port", p)


@pytest.fixture(scope="module")
def f32():
    return _Side("test-gpt", quant=False)


@pytest.fixture(scope="module")
def int8():
    return _Side("test-gpt-mega", quant=True)


@pytest.fixture(scope="module")
def mega():
    return _Side("test-gpt-mega", quant=True, megakernel=True)


def _prompts(seed, lengths, vocab=300):
    rng = np.random.RandomState(seed)
    return [[int(t) for t in rng.randint(1, vocab, n)] for n in lengths]


MODES = {
    "wave_deferred": dict(),                                     # the defaults: run() defers its fetches
    "per_step": dict(wave=False, burst=1),
    "tokenwise_prefill": dict(wave=False, burst=1, prefill_chunk=False),
    "burst": dict(wave=False, burst=4, pipeline=1),
    "chained_bursts": dict(wave=False, burst=3, pipeline=3),
    "wave_short_bursts": dict(burst=2, pipeline=2),
}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_engine_modes_give_the_solo_samplers_ids(f32, mode):
    """More requests than slots with staggered budgets: slots are reused while
    others are mid-decode."""
    prompts = _prompts(0, (3, 7, 5, 4, 2, 6))
    eng = ContinuousBatcher(f32.tm, batch_slots=3, max_len=64, greedy=True, **MODES[mode])
    reqs = [eng.submit(p, max_new_tokens=4 + i % 4) for i, p in enumerate(prompts)]
    done = eng.run()
    assert len(done) == len(prompts)
    f32.check(reqs, prompts)


@pytest.mark.parametrize("mode", ["wave_deferred", "per_step", "burst"])
def test_mid_stream_admission_and_slot_reuse(f32, mode):
    prompts = _prompts(1, [2 + i % 5 for i in range(7)])
    eng = ContinuousBatcher(f32.tm, batch_slots=2, max_len=64, greedy=True, **MODES[mode])
    reqs = [eng.submit(prompts[0], 5), eng.submit(prompts[1], 9)]
    done = []
    for _ in range(4):      # the first two make progress, then the rest trickle in
        done += eng.step()
    reqs += [eng.submit(p, 4 + i % 3) for i, p in enumerate(prompts[2:])]
    done += eng.run()
    assert len(done) == 7
    f32.check(reqs, prompts)


@pytest.mark.parametrize("mode", ["wave_deferred", "per_step", "chained_bursts"])
def test_eot_retires_a_request_and_frees_its_slot(f32, mode):
    """With an ``eot_id`` scheduling depends on the data: one fetch per wave."""
    prompts = _prompts(2, (3, 5, 4))
    eot = f32.torch(prompts[0], 8)[2]
    eng = ContinuousBatcher(f32.tm, batch_slots=2, max_len=48, greedy=True, eot_id=eot,
                            **MODES[mode])
    reqs = [eng.submit(p, max_new_tokens=8) for p in prompts]
    eng.run()
    assert reqs[0].out_ids[-1] == eot and len(reqs[0].out_ids) <= 3
    f32.check(reqs, prompts, eot_id=eot)


def test_int8_engine_streams_the_quantised_tree(int8):
    """``quant_int8``: the engine quantises the tree itself and reads logits off
    its int8 head table; ids equal the solo int8 samplers'."""
    prompts = _prompts(3, (3, 6, 2, 5))
    plain = make_pair("clip_gpt", "test-gpt-mega")[2]
    eng = ContinuousBatcher(plain, batch_slots=2, max_len=48, greedy=True, quant_int8=True,
                            burst=4, pipeline=2)
    assert eng._head_table is not None
    reqs = [eng.submit(p, max_new_tokens=5) for p in prompts]
    eng.run()
    int8.check(reqs, prompts)


@pytest.mark.parametrize("store", ["int8", "bf16"])
def test_megakernel_samplers_give_the_jax_packages_ids(mega, store):
    from summer_clip_tpu.apps import gen_gpt as jgen

    if store == "int8":
        jm, jv, tm, quant = mega.jm, mega.jv, mega.tm, True
    else:   # an explicit megakernel=True on an f32 tree: bf16 weights and rings
        jm, jv, tm = make_pair("clip_gpt", "test-gpt-mega")
        quant = False
    kw = dict(max_new_tokens=6, top_k=1, quant_int8=quant, megakernel=True)
    prompts = _prompts(4, (3, 1, 17))
    for p in prompts[:2]:
        assert tgen.generate_device(tm, p, **kw) == jgen.generate_device(jm, jv, p, **kw)
    got = tgen.generate_device_batched(tm, prompts, **kw)
    assert got == jgen.generate_device_batched(jm, jv, prompts, **kw)
    for p, row in zip(prompts, got):
        assert row == tgen.generate_device(tm, p, **kw)
    with pytest.raises(ValueError, match="at most 8"):
        tgen.generate_device_batched(tm, prompts * 3, **kw)


def test_megakernel_engine_gives_the_solo_megakernel_samplers_ids(mega):
    prompts = _prompts(5, (3, 7, 5))
    eng = ContinuousBatcher(mega.tm, batch_slots=3, max_len=96, greedy=True, quant_int8=True,
                            megakernel=True, burst=4, pipeline=2)
    reqs = [eng.submit(p, max_new_tokens=m) for p, m in zip(prompts, (6, 3, 8))]
    assert len(eng.run()) == 3
    mega.check(reqs, prompts)


def test_megakernel_engine_equals_the_jax_engine_with_slot_reuse(mega):
    from summer_clip_tpu.engine.serving import ContinuousBatcher as JaxBatcher

    # (both engines part from the solo sampler on one of these prompts' first
    # token: the batched bucket prefill and the solo prefill of an int8 tree
    # are two routes, and random weights leave near-ties)
    prompts = _prompts(6, [2 + i % 4 for i in range(5)])
    kw = dict(batch_slots=2, max_len=96, greedy=True, quant_int8=True, megakernel=True, burst=4,
              pipeline=2)
    outs = []
    for eng in (JaxBatcher(mega.jm, mega.jv, **kw), ContinuousBatcher(mega.tm, **kw)):
        reqs = [eng.submit(prompts[0], 5), eng.submit(prompts[1], 7)]
        done = []
        for _ in range(2):
            done += eng.step()
        reqs += [eng.submit(p, 4 + i % 2) for i, p in enumerate(prompts[2:])]
        done += eng.run()
        assert len(done) == 5
        outs.append([r.out_ids for r in reqs])
    assert outs[0] == outs[1]


def test_megakernel_engine_eot_and_ring_clamp(mega):
    """A free slot's ring advances with every burst and clamps at the ring's
    end; a request admitted into it afterwards is not disturbed."""
    prompt = [5, 9, 2]
    first = mega.torch(prompt, 1)[0]
    eng = ContinuousBatcher(mega.tm, batch_slots=2, max_len=40, greedy=True, quant_int8=True,
                            megakernel=True, eot_id=first, burst=4, pipeline=2)
    r = eng.submit(prompt, max_new_tokens=10)
    eng.run()
    assert r.done and r.out_ids == [first]
    eng = ContinuousBatcher(mega.tm, batch_slots=2, max_len=40, greedy=True, quant_int8=True,
                            megakernel=True, burst=8, pipeline=4)
    eng._ring[1] = 10_000       # a slot that stayed free for long: its writes clamp
    prompts = _prompts(7, (3, 4))
    reqs = [eng.submit(prompts[0], 20)]
    eng.step()
    reqs.append(eng.submit(prompts[1], 6))
    eng.run()
    mega.check(reqs, prompts)


def test_engine_refuses_what_it_cannot_serve(f32, mega):
    with pytest.raises(ValueError, match="int8"):
        ContinuousBatcher(make_pair("clip_gpt", "test-gpt-mega")[2], batch_slots=2, max_len=96,
                          megakernel=True)
    with pytest.raises(ValueError, match="wave"):
        ContinuousBatcher(mega.tm, quant_int8=True, megakernel=True, wave=False)
    with pytest.raises(ValueError, match="at most 8"):
        ContinuousBatcher(mega.tm, quant_int8=True, megakernel=True, batch_slots=9)
    with pytest.raises(ValueError, match="geometry"):
        ContinuousBatcher(f32.tm, quant_int8=True, megakernel=True)
    with pytest.raises(NotImplementedError, match="Queue 1 item 11"):
        ContinuousBatcher(f32.tm, mesh=object())
    eng = ContinuousBatcher(f32.tm, batch_slots=1, max_len=16)
    with pytest.raises(ValueError, match="exceeds"):
        eng.submit(list(range(1, 13)), max_new_tokens=8)
    with pytest.raises(ValueError, match="empty"):
        eng.submit([], max_new_tokens=2)
    eng = ContinuousBatcher(mega.tm, batch_slots=2, max_len=32, quant_int8=True, megakernel=True)
    with pytest.raises(ValueError, match="bucket"):
        eng.submit(list(range(1, 18)), max_new_tokens=4)   # 17 tokens: a bucket of 32


@pytest.mark.parametrize("megakernel", [False, True], ids=["k7_engine", "megakernel"])
def test_sampling_draws_once_a_step_whatever_the_burst(mega, megakernel):
    """One generator, consumed once an iteration: bursts of 1 x 6, 2 x 3 and
    6 x 1 steps draw the same tokens from the same seed."""
    prompts = _prompts(8, (3, 2))
    outs = []
    for burst, pipeline in ((6, 1), (3, 2), (2, 3)):
        eng = ContinuousBatcher(mega.tm, batch_slots=2, max_len=48, temperature=0.8, top_k=5,
                                quant_int8=True, megakernel=megakernel, burst=burst,
                                pipeline=pipeline, generator=torch.Generator().manual_seed(3))
        reqs = [eng.submit(p, 7) for p in prompts]
        eng.run()
        assert all(len(r.out_ids) == 7 and all(0 <= t < 300 for t in r.out_ids) for r in reqs)
        outs.append([r.out_ids for r in reqs])
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.cuda
def test_cuda_megakernel_engine_runs_k8_and_gives_the_solo_samplers_ids():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = tgen.build_clip_gpt({"gpt_config": "test-gpt-mega", "clip_emb_dim": 16,
                                 "adapters": {"emb_hid_dim": 24, "head_hid_dim": 24}}, 300, 3)
    qmodel = model.with_tree(quantize_tree(model.tree())).eval()
    prompts = _prompts(9, (3, 7, 5, 2, 6))
    before = DB.decode_block.launches
    eng = ContinuousBatcher(model, batch_slots=2, max_len=96, greedy=True, quant_int8=True,
                            megakernel=True, burst=4, pipeline=2)
    reqs = [eng.submit(p, max_new_tokens=4 + i % 3) for i, p in enumerate(prompts)]
    eng.run()
    assert DB.decode_block.launches > before
    same = sum(r.out_ids == tgen.generate_device(qmodel, p, max_new_tokens=r.max_new_tokens, top_k=1,
                                                 quant_int8=True, megakernel=True)[len(p):]
               for r, p in zip(reqs, prompts))
    # the wide prefill of a batch and of one prompt may sum in another order on
    # the card, so a near-tie may part two requests; most are the same
    assert same >= len(prompts) - 1
