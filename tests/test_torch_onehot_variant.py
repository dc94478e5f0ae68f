"""K13 (``onehot_variant``) of the port against the JAX sweep tool's kernel.

The JAX side is ``tools/sweep_onehot_variants.onehot_variant`` run in Pallas
interpret mode (``pl.pallas_call`` patched with ``interpret=True`` inside the
test; nothing in ``tools/`` changes). Importing the tool repoints JAX's
persistent compilation cache at the repo's ``.jax_cache``, so the module
fixture loads it after ``tests/conftest.py`` has set the cache and restores that
setting afterwards.

Inputs: 48 queries, D = 128, 16 classes, 240 sorted cache rows padded to two
blocks of 128, so classes cross the block boundary; bf16 unit rows made with
numpy from a seed. What holds, and why:

- ``cast_w=True``: both sides form the same bf16 weights from the same bf16
  features and sum the same per-block class partials in f32, so
  ``"highest"`` and ``"split3"`` agree exactly, except where the two
  libraries' f32 ``exp`` (or the f32 sum of the affinity) differ in the last
  bit and the weight rounds to the neighbouring bf16 value: such an output
  moves by one bf16 step of one weight (at most 2^-8 for a weight <= 1). At
  most one output in a thousand may do so (one of 6144 here).
- ``"default"`` rounds each block's class partial to bf16 (within 2^-8
  relative: bf16 keeps 8 significant bits); the interpret mode runs that
  product in f32 and cannot show the cut, so the port's ``"default"`` is held
  within 2^-8 relative, output by output, of ``"highest"`` (the weights are
  positive, so the relative bound of each partial bounds their sum).
- ``cast_w=False``: the interpret mode keeps the weights in f32; the port's
  bf16 route rounds them to bf16 (within 2^-8 relative each, all positive), so
  it is held within 2^-8 relative, output by output (2^-7 for ``"default"``,
  which rounds once more). The port's f32 route (``compute_dtype=float32``)
  keeps them in f32 and holds within 1e-5.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from summer_clip_torch.ops import cache_kernels as ck

ROOT = Path(__file__).resolve().parent.parent
NT, D, C, NC, BLOCK_N = 48, 128, 16, 240, 128
BETAS = np.linspace(0.1, 11.5, 8).astype(np.float32)
BF16_WEIGHT_STEP = 2.0 ** -8     # one bf16 step of a weight <= 1
DEFAULT_REL = 2.0 ** -8          # "default" against "highest", relative, output by output
CAST_W_REL = 2.0 ** -8           # bf16 weights against f32 weights, relative


@pytest.fixture(scope="module")
def tool():
    import jax

    keys = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs",
            "jax_persistent_cache_min_entry_size_bytes")
    saved = {k: getattr(jax.config, k) for k in keys}
    try:
        spec = importlib.util.spec_from_file_location(
            "sweep_onehot_variants", ROOT / "tools" / "sweep_onehot_variants.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
    return module


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(0)

    def unit(n):
        a = rng.standard_normal((n, D)).astype(np.float32)
        return a / np.linalg.norm(a, axis=1, keepdims=True)

    f, cf = unit(NT), unit(NC)
    labels = np.sort(rng.integers(0, C, NC)).astype(np.int32)
    # bf16 rows, as the tool's bench makes them: both sides see the same values
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16).float().numpy()  # noqa: E731
    return bf(f), bf(cf), labels


def _jax(tool, monkeypatch, f, cf, labels, mode, cast_w):
    import jax.numpy as jnp

    monkeypatch.setattr(tool.pl, "pallas_call",
                        functools.partial(tool.pl.pallas_call, interpret=True))
    pad = (-labels.shape[0]) % BLOCK_N
    padded = np.concatenate([labels, np.full(pad, -1, np.int32)])
    crow8, ccol128, _ = tool.ca.onehot_table_operands(padded, BLOCK_N)
    return np.asarray(tool.onehot_variant(
        jnp.asarray(f, jnp.bfloat16), jnp.asarray(cf, jnp.bfloat16),
        jnp.asarray(padded.reshape(-1, 1)),
        jnp.asarray(crow8), jnp.asarray(ccol128), jnp.asarray(BETAS), block_q=64,
        block_n=BLOCK_N, block_b=4, c_p=128, num_classes=C, compute_dtype=jnp.bfloat16,
        expand_mode=mode, cast_w=cast_w))


def _port(f, cf, labels, mode, cast_w, compute_dtype=torch.bfloat16):
    return ck.onehot_variant_reference(
        torch.from_numpy(f), torch.from_numpy(cf), labels, BETAS, C, block_n=BLOCK_N,
        expand_mode=mode, cast_w=cast_w, compute_dtype=compute_dtype).numpy()


@pytest.mark.parametrize("mode", ["highest", "split3"])
def test_exact_modes_match_jax_with_cast_w(tool, inputs, monkeypatch, mode):
    f, cf, labels = inputs
    want = _jax(tool, monkeypatch, f, cf, labels, mode, True)
    got = _port(f, cf, labels, mode, True)
    assert got.shape == (BETAS.shape[0], NT, C)
    diff = np.abs(got - want)
    assert (diff > 0).mean() <= 1e-3, f"{int((diff > 0).sum())} outputs differ"
    assert diff.max() <= BF16_WEIGHT_STEP


def test_split3_equals_highest_bit_for_bit(inputs):
    f, cf, labels = inputs
    for cast_w in (True, False):
        np.testing.assert_array_equal(_port(f, cf, labels, "split3", cast_w),
                                      _port(f, cf, labels, "highest", cast_w))


def test_default_within_bf16_of_highest(tool, inputs, monkeypatch):
    f, cf, labels = inputs
    highest = _jax(tool, monkeypatch, f, cf, labels, "highest", True)
    default = _port(f, cf, labels, "default", True)
    assert np.all(np.abs(default - highest) <= DEFAULT_REL * np.abs(highest) + 1e-6)
    # the cut is there: "default" differs from "highest" on most outputs
    assert (default != _port(f, cf, labels, "highest", True)).mean() > 0.5
    # the interpret mode's "default" runs in f32 and equals its "highest"
    np.testing.assert_allclose(_jax(tool, monkeypatch, f, cf, labels, "default", True), highest,
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", ["split3", "default"])
def test_without_cast_w(tool, inputs, monkeypatch, mode):
    f, cf, labels = inputs
    want = _jax(tool, monkeypatch, f, cf, labels, mode, False)
    port_mode_rel = DEFAULT_REL if mode == "default" else 0.0
    got = _port(f, cf, labels, mode, False)   # bf16 route: the weights rounded to bf16
    assert np.all(np.abs(got - want) <= (CAST_W_REL + port_mode_rel) * want + 1e-6)
    if mode == "split3":
        got32 = _port(f, cf, labels, mode, False, compute_dtype=torch.float32)
        np.testing.assert_allclose(got32, want, rtol=1e-5, atol=1e-5)


def test_blocks_split_classes_and_pad(inputs):
    """A class whose rows cross a block boundary gets two partials; labels -1
    add nothing; the wrapper's CPU route is the bf16 plain version."""
    f, cf, labels = inputs
    assert len(set(labels[:BLOCK_N]) & set(labels[BLOCK_N:])) >= 1
    lab = labels.copy()
    lab[:5] = -1
    got = ck.onehot_variant(torch.from_numpy(f), torch.from_numpy(cf), lab, BETAS, C,
                            block_n=BLOCK_N, expand_mode="highest")
    want = ck.cache_attention_labels_reference(
        torch.from_numpy(f), torch.from_numpy(cf), torch.from_numpy(lab), torch.from_numpy(BETAS),
        C, compute_dtype=torch.bfloat16)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)
    assert ck.onehot_variant.launches == 0


def test_bad_arguments_raise():
    f = torch.zeros(3, D)
    with pytest.raises(ValueError, match="expand_mode"):
        ck.onehot_variant(f, torch.zeros(4, D), [0, 1, 2, 3], [1.0], 7, expand_mode="fast")
    with pytest.raises(ValueError, match="out of range"):
        ck.onehot_variant(f, torch.zeros(4, D), [0, 1, 7, 0], [1.0], 7)
    meta = torch.empty(3, D, device="meta")
    with pytest.raises(ValueError, match="CUDA"):      # a non-CPU tensor launches or raises
        ck.onehot_variant(meta, torch.empty(4, D, device="meta"), [0, 1, 2, 3], [1.0], 7)
    assert ck.onehot_variant.launches == 0


def test_sweep_tool_runs_on_the_cpu(capsys):
    """``tools/torch_sweep_onehot_variants.bench`` at a toy size through the
    plain versions. On the CPU K1's plain version keeps the weights in f32 and
    K13's rounds them to bf16 (within 2^-8 relative each, all positive); the
    "default" arm's bf16 partials add 2^-8 more."""
    spec = importlib.util.spec_from_file_location(
        "torch_sweep_onehot_variants", ROOT / "tools" / "torch_sweep_onehot_variants.py")
    sweep = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sweep)
    out = sweep.bench(40, 0, 32, 6, rows_per_class=5, device="cpu", block_ns=(8, 16))
    assert out["nc"] == 30 and len(out["rows"]) == 1 + 2 * len(sweep.ARMS)
    for row in out["rows"][1:]:
        assert row["checksum_rel"] <= CAST_W_REL * (2 if row["mode"] == "default" else 1), row
    assert "split3 block_n=16" in capsys.readouterr().out


@pytest.mark.cuda
def test_cuda_k13_matches_plain(monkeypatch):
    """On the card: each arm against its plain version (a weight may round to
    the neighbouring bf16 value where the two f32 affinities differ in their
    last bit: K3's 2e-2; "default" may round a partial one bf16 step, 2^-7 of
    its binade, further), "highest" and "split3" against K3 (the same weights,
    partials summed apart: 1e-5 of max |out|) and bit for bit against each
    other; classes across block_n blocks and across work items (1, 3 and 7
    items), and a cache collapsed onto one class; two runs equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    rng = np.random.default_rng(9)
    a = rng.standard_normal((200 + 900, 512)).astype(np.float32)
    a /= np.linalg.norm(a, axis=1, keepdims=True)
    f, keys = torch.from_numpy(a[:200]).cuda(), torch.from_numpy(a[200:]).cuda()
    betas = torch.linspace(0.1, 6.9, 20).cuda()
    cases = {"classes cross blocks": np.sort(rng.integers(0, 40, 900)).astype(np.int32),
             "one_class_90": np.sort(rng.choice([3, 17, 31], 900, p=[0.9, 0.07, 0.03])
                                     ).astype(np.int32)}
    for name, labels in cases.items():
        for items in (1, 3, 7):
            monkeypatch.setattr(ck, "grouped_items", lambda *a, _n=items, **k: _n)
            k3 = ck.cache_attention_onehot(f, keys, labels, betas, 40)
            out = {}
            for mode in ck.EXPAND_MODES:
                got, again = (ck.onehot_variant(f, keys, labels, betas, 40, block_n=128,
                                                expand_mode=mode) for _ in "ab")
                want = ck.onehot_variant_reference(f, keys, labels, betas, 40, block_n=128,
                                                   expand_mode=mode)
                torch.cuda.synchronize()
                scale = float(want.abs().max())
                step = 2.0 ** -7 * scale if mode == "default" else 0.0
                assert float((got - want).abs().max()) <= 2e-2 + step, (name, items, mode)
                assert torch.equal(got, again), (name, items, mode)
                out[mode] = got
            assert torch.equal(out["highest"], out["split3"])
            assert float((out["highest"] - k3).abs().max()) <= 1e-5 * scale
            rel = ((out["default"] - out["highest"]).abs()
                   / out["highest"].abs().clamp_min(1e-30)).max()
            assert float(rel) <= DEFAULT_REL
