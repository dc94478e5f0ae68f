"""The port's native JPEG path (``summer_clip_torch.native``) against the JAX
package's (``summer_clip_tpu.native``): the same C++ source, so the same
pixels; the loader's choice of path and its failed-row rule; and
``save_features`` over a seed-made Caltech101 tree of JPEG files through both
packages' apps. Skipped, as ``tests/test_native.py`` is, where the JAX library
does not build (no g++ or no libjpeg).

The port decodes with Pillow's libjpeg at the library's DCT scale and runs
the C++ resize, crop and normalize; the JAX library decodes with libjpeg in
C++. On the same libjpeg both give the same pixels.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

from summer_clip_torch import native
from summer_clip_tpu import native as jax_native

pytestmark = pytest.mark.skipif(not jax_native.is_available(),
                                reason="the JAX package's native library does not build here")

REPO = Path(__file__).resolve().parent.parent
# (height, width): ImageNet's common size both ways, the DCT-scaled branch
# (1200 x 1600: 1/2 at 224, 1/8 at 32), Caltech101's typical size, a wide one
SHAPES = [(375, 500), (500, 375), (1200, 1600), (200, 300), (100, 400)]


def _smooth(rng, h, w, noise=12):
    coarse = (rng.random((h // 40 + 2, w // 40 + 2, 3)) * 255).astype(np.uint8)
    arr = np.asarray(Image.fromarray(coarse).resize((w, h), Image.BILINEAR), np.int16)
    return np.clip(arr + rng.integers(-noise, noise + 1, arr.shape), 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("native_jpegs")
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(SHAPES):
        p = tmp / f"{i}.jpg"
        Image.fromarray(_smooth(rng, h, w)).save(p, quality=90)
        paths.append(str(p))
    p = tmp / "gray.jpg"
    Image.fromarray((rng.random((300, 400)) * 255).astype(np.uint8)).save(p, quality=90)
    return paths + [str(p)]


def test_library_builds_from_the_ports_source_into_the_ports_build_dir():
    lib = native.ensure_built()
    assert Path(lib._name).parent == REPO / "summer_clip_torch" / "build"
    assert native._SRC == REPO / "summer_clip_torch" / "native" / "clip_preprocess.cpp"
    # the same rule as the JAX library's: 2x (fast: 1x) the target's short side
    assert [lib.clip_preprocess_denom(1600, 1200, s, 0) for s in (224, 64, 32)] == [2, 8, 8]
    assert [lib.clip_preprocess_denom(1600, 1200, s, 1) for s in (224, 600, 601)] == [4, 2, 1]
    assert lib.clip_preprocess_denom(500, 375, 224, 0) == 1


@pytest.mark.parametrize("threads", [1, 3])
@pytest.mark.parametrize("size", [224, 32])
@pytest.mark.parametrize("fast", [False, True], ids=["slow", "fast"])
def test_preprocess_batch_equals_the_jax_library(jpegs, fast, size, threads):
    """Every shape, the DCT-scaled branch included, within 1e-6 of the JAX
    library, on one thread and on several."""
    want, want_ok = jax_native.preprocess_batch(jpegs, size, num_threads=3, fast=fast)
    got, ok = native.preprocess_batch(jpegs, size, num_threads=threads, fast=fast)
    assert got.shape == (len(jpegs), size, size, 3) and got.dtype == np.float32
    assert ok.all() and want_ok.all()
    assert np.abs(got - want).max() <= 1e-6


def test_preprocess_one_equals_the_jax_library(jpegs):
    for p in jpegs[:3]:
        np.testing.assert_allclose(native.preprocess_one(p, 64), jax_native.preprocess_one(p, 64),
                                   rtol=0, atol=1e-6)


def test_close_to_the_ports_pil_transform(jpegs):
    """Within the JAX test's bound of PIL's EvalTransform (mean |d| 0.03)."""
    from summer_clip_torch.data.transforms import EvalTransform, load_image

    imgs, ok = native.preprocess_batch(jpegs, 224)
    t = EvalTransform(224)
    for i, p in enumerate(jpegs):
        assert np.abs(imgs[i] - t(load_image(p))).mean() < 0.03, p


def test_fast_mode_differs_and_stays_close(jpegs):
    slow, _ = native.preprocess_batch(jpegs[:3], 224)
    fast, _ = native.preprocess_batch(jpegs[:3], 224, fast=True)
    assert np.abs(fast - slow).max() > 0.0
    assert np.abs(fast - slow).mean() < 0.05


def test_corrupt_file_gives_a_failed_zero_row(jpegs, tmp_path):
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"not a jpeg")
    png = tmp_path / "png.jpg"
    Image.open(jpegs[0]).save(png, format="PNG")
    imgs, ok = native.preprocess_batch([jpegs[0], str(bad), str(tmp_path / "missing.jpg")], 32)
    assert ok.tolist() == [True, False, False]
    assert np.abs(imgs[1:]).max() == 0.0
    assert native.preprocess_one(str(bad), 32) is None
    assert jax_native.preprocess_one(str(png), 32) is None
    assert native.preprocess_batch([str(png)], 32)[1].tolist() == [False]


def _batchers(paths, **kw):
    from summer_clip_torch.data.core import Datum as TDatum
    from summer_clip_torch.data.loader import ImageBatcher as TBatcher
    from summer_clip_tpu.data.core import Datum as JDatum
    from summer_clip_tpu.data.loader import ImageBatcher as JBatcher

    tkw = {k: (v[0] if isinstance(v, tuple) else v) for k, v in kw.items()}
    jkw = {k: (v[1] if isinstance(v, tuple) else v) for k, v in kw.items()}
    return (TBatcher([TDatum(impath=p, label=i % 2) for i, p in enumerate(paths)], **tkw),
            JBatcher([JDatum(impath=p, label=i % 2) for i, p in enumerate(paths)], **jkw))


def _transforms(kind, device_normalize=False):
    from summer_clip_torch.data import transforms as T
    from summer_clip_tpu.data import transforms as J

    name = {"eval": "EvalTransform", "train": "TrainTransform"}[kind]
    return (getattr(T, name)(32, device_normalize=device_normalize),
            getattr(J, name)(32, device_normalize=device_normalize))


@pytest.mark.parametrize("case", ["jpeg", "png", "k_tfm2", "train_transform", "off", "asked"])
def test_batcher_picks_the_jax_batchers_path(jpegs, tmp_path, case):
    paths = jpegs[:2]
    if case == "png":
        paths = []
        for i, p in enumerate(jpegs[:2]):
            paths.append(str(tmp_path / f"{i}.png"))
            Image.open(p).save(paths[-1])
    kw = {"batch_size": 2, "transform": _transforms("train" if case == "train_transform" else "eval")}
    kw.update({"k_tfm2": {"k_tfm": 2}, "off": {"use_native": False},
               "asked": {"use_native": True}}.get(case, {}))
    port, ref = _batchers(paths, **kw)
    assert port.use_native == ref.use_native
    assert port.use_native == (case in ("jpeg", "asked"))


def test_asked_for_native_with_another_transform_raises(jpegs):
    """``use_native=True`` with a train transform raises rather than drop its
    augmentation (the JAX batcher decodes those rows with the eval path)."""
    from summer_clip_torch.data.core import Datum
    from summer_clip_torch.data.loader import ImageBatcher

    data = [Datum(impath=p, label=0) for p in jpegs[:2]]
    with pytest.raises(ValueError, match="TrainTransform"):
        ImageBatcher(data, batch_size=2, transform=_transforms("train")[0], use_native=True)
    assert not ImageBatcher(data, batch_size=2, transform=_transforms("train")[0]).use_native


def test_native_batch_with_a_failed_row_equals_the_jax_batch(jpegs, monkeypatch):
    """Row 1 fails in both libraries; under ``device_normalize=True`` its PIL
    row is normalized like the native rows, in both packages alike."""
    def fail_row_1(real):
        def call(paths, out_size, num_threads=0, out=None, fast=False, **kw):
            imgs, ok = real(paths, out_size, num_threads=num_threads, out=out, fast=fast, **kw)
            ok = ok.copy()
            ok[1], imgs[1] = False, 0.0
            return imgs, ok
        return call

    monkeypatch.setattr(native, "preprocess_batch", fail_row_1(native.preprocess_batch))
    monkeypatch.setattr(jax_native, "preprocess_batch", fail_row_1(jax_native.preprocess_batch))
    port, ref = _batchers(jpegs[:3], batch_size=4,
                          transform=_transforms("eval", device_normalize=True))
    assert port.use_native and ref.use_native
    got, want = next(iter(port)), next(iter(ref))
    assert got.images.dtype == want.images.dtype == np.float32
    assert np.abs(got.images - want.images).max() <= 1e-6
    assert np.abs(got.images[1]).max() < 4.0 and np.abs(got.images[1]).max() > 0.0
    np.testing.assert_array_equal(got.mask, want.mask)
    np.testing.assert_array_equal(got.indices, want.indices)


def test_asked_for_native_raises_when_the_build_fails(jpegs, tmp_path, monkeypatch):
    """A compiler that fails: ``use_native=True`` raises with its output, at
    every call; the automatic choice quietly decodes with PIL, as the JAX
    batcher does where its library does not build."""
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'this compiler refuses every source' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_build_error", None)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="this compiler refuses every source"):
            _batchers(jpegs[:2], batch_size=2, transform=_transforms("eval"), use_native=True)
    with pytest.raises(RuntimeError, match="this compiler refuses every source"):
        native.preprocess_batch(jpegs[:1], 32)
    assert not native.is_available()
    port, _ = _batchers(jpegs[:2], batch_size=2, transform=_transforms("eval"))
    assert not port.use_native
    assert next(iter(port)).images.shape == (2, 32, 32, 3)


def test_shard_decodes_only_its_rows(jpegs, monkeypatch):
    from summer_clip_torch.data.core import Datum
    from summer_clip_torch.data.loader import ImageBatcher

    data = [Datum(impath=p, label=i) for i, p in enumerate(jpegs)]
    whole = list(ImageBatcher(data, batch_size=4, transform=_transforms("eval")[0]))
    asked = []
    real = native.preprocess_batch
    monkeypatch.setattr(native, "preprocess_batch",
                        lambda paths, *a, **k: (asked.extend(paths), real(paths, *a, **k))[1])
    for rank in range(2):
        asked.clear()
        shard = ImageBatcher(data, batch_size=4, transform=_transforms("eval")[0]).shard(rank, 2)
        assert shard.use_native
        got = list(shard)
        assert sorted(asked) == sorted(jpegs[i] for i in range(len(jpegs)) if i % 4 // 2 == rank)
        for g, w in zip(got, whole):
            np.testing.assert_array_equal(g.images, w.images[2 * rank:2 * rank + 2])
            np.testing.assert_array_equal(g.mask, w.mask[2 * rank:2 * rank + 2])


def test_session_normalizes_uint8_and_passes_float32_through():
    from summer_clip_torch.apps.common import create_clip_session
    from summer_clip_torch.data.transforms import CLIP_MEAN, CLIP_STD

    session = create_clip_session("test-vit", device="cpu")
    rng = np.random.default_rng(0)
    raw = rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8)
    normed = ((raw / 255.0 - CLIP_MEAN) / CLIP_STD).astype(np.float32)
    np.testing.assert_array_equal(session._prep(normed).numpy(), normed)
    np.testing.assert_allclose(session._prep(raw).numpy(), normed, rtol=0, atol=1e-6)


def _save_features(pkg, root, data, ckpt, extra, monkeypatch):
    import importlib

    app = importlib.import_module(f"{pkg}.apps.save_features")
    store = root / "features"
    root.mkdir(parents=True)
    monkeypatch.chdir(root)
    app.run(argv=["clip=test_vit", f"clip.checkpoint_path={ckpt}", "dataset_name=caltech101",
                  f"path.cache_dir={data}", "data.batch_size=8", f"store.root={store}",
                  *(["meta.device=cpu"] if pkg == "summer_clip_torch" else []), *extra])
    return importlib.import_module(f"{pkg}.store").FeatureStore(store)


def test_save_features_on_a_caltech_tree_matches_jax(tmp_path, monkeypatch):
    """A Caltech101 tree of JPEG files (``chip_smoke.write_caltech_tree``, 4
    classes) through both packages' save_features at test-vit: the port's
    stores equal the JAX app's within the pipeline test's 1e-4 (the test split
    takes the native path in both), and the port's PIL run (the library
    reported missing) parts from them on the test split, not on the train
    split."""
    import chip_smoke
    from summer_clip_torch.models.clip import build_clip, to_openai_state_dict

    data = tmp_path / "data"
    rows = chip_smoke.write_caltech_tree(data, seed=0, n_images=24, n_classes=4, threads=4)
    split = json.loads((data / "caltech-101" / "split_zhou_Caltech101.json").read_text())
    assert rows == {"train": 12, "val": 0, "test": 12} and len(split["test"]) == 12
    sizes = {Image.open(data / "caltech-101" / "101_ObjectCategories" / r[0]).size
             for r in split["test"]}
    assert sizes == set(chip_smoke.JPEG_SIZES)
    model, _ = build_clip("test-vit", torch.Generator().manual_seed(3), device="cpu")
    ckpt = tmp_path / "test_vit.pt"
    torch.save(to_openai_state_dict(model), ckpt)

    ref = _save_features("summer_clip_tpu", tmp_path / "jax", data, ckpt, [], monkeypatch)
    got = _save_features("summer_clip_torch", tmp_path / "port", data, ckpt, [], monkeypatch)
    from summer_clip_torch.data.loader import ImageBatcher

    monkeypatch.setattr(ImageBatcher, "_native_available", staticmethod(lambda: False))
    pil = _save_features("summer_clip_torch", tmp_path / "pil", data, ckpt, [], monkeypatch)
    for split_name in ("train", "test"):
        key = f"caltech101_{split_name}-test-vit"
        np.testing.assert_allclose(got.load(key, "features"), ref.load(key, "features"),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_array_equal(got.load(key, "labels"), ref.load(key, "labels"))
        apart = np.abs(pil.load(key, "features") - ref.load(key, "features")).max()
        assert (apart > 1e-3) == (split_name == "test"), (split_name, apart)
    np.testing.assert_allclose(got.load("caltech101_train-test-vit", "outs"),
                               ref.load("caltech101_train-test-vit", "outs"), rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def pixel_readings(tmp_path_factory):
    """``chip_smoke``'s pixel gate over the first test files of its Caltech101
    tree (the same files as the full tree's: the pixels of image ``i`` depend on
    ``(seed, i)`` and its size only)."""
    import chip_smoke
    from summer_clip_torch.data.datasets import build_dataset

    root = tmp_path_factory.mktemp("caltech")
    chip_smoke.write_caltech_tree(root, seed=0, n_images=2 * chip_smoke.JPEG_CPU_ROWS + 32,
                                  threads=4)
    test = build_dataset("caltech101", str(root), -1).test
    paths = [d.impath for d in test[:chip_smoke.JPEG_CPU_ROWS]]
    pixels, ok = native.preprocess_batch(paths, 224)
    assert ok.all()
    return chip_smoke.jpeg_pixel_readings(paths, pixels)


@pytest.mark.parametrize("case", ["native", "the crop one pixel off", "bilinear taps"])
def test_pixel_gate_passes_the_library_and_fails_the_planted_faults(pixel_readings, case):
    """The native library's pixels are within ``chip_smoke``'s pixel limits of
    PIL's EvalTransform; each planted fault reads past both."""
    import chip_smoke

    mean, top = pixel_readings[case]
    inside = (mean <= chip_smoke.TOL_JPEG_PIX_MEAN, top <= chip_smoke.TOL_JPEG_PIX_MAX)
    assert inside == ((True, True) if case == "native" else (False, False)), (case, mean, top)
