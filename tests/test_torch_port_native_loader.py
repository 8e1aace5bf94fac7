"""The port's C++ loader (``csrc/loader.cpp`` through
``movedepth_tpu_torch/data/native_loader.py``) on the CPU: decode, the
chained Lanczos pyramid against PIL, flips, zero fill, the fused jitter
against its numpy version and PIL's, both build routes (``a``: libjpeg and
libpng in C++, ``b``: Pillow decode), and the port's library against the
JAX package's (``native/loader.cpp``) built on the same host with the same
flags, bit for bit. A failed build raises and names ``--no-native_loader``.
"""

import os
import threading

import numpy as np
import pytest
from PIL import Image

from movedepth_tpu.data import kitti as JK
from movedepth_tpu.data import native_loader as JNL
from movedepth_tpu_torch import native
from movedepth_tpu_torch.data import kitti as K
from movedepth_tpu_torch.data import native_loader as NL

ROUTES = ("a", "b")


@pytest.fixture(scope="module")
def jax_lib():
    """The JAX package's binding, its library built here by its Makefile."""
    if not JNL.available():
        pytest.skip("the JAX package's native/loader.cpp does not build here "
                    "(make, g++, libjpeg or libpng missing)")
    return JNL


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """A 620x190 gradient as PNG and as JPEG, and a smooth 310x94 texture
    as JPEG (quality 90, as KITTI's frames)."""
    root = tmp_path_factory.mktemp("native_loader")
    y, x = np.mgrid[0:190, 0:620]
    grad = np.stack([x * 255 / 620, y * 255 / 190,
                     (x + y) * 255 / 810], -1).astype(np.uint8)
    Image.fromarray(grad).save(root / "g.png")
    Image.fromarray(grad).save(root / "g.jpg", quality=95)
    rng = np.random.default_rng(0)
    small = rng.uniform(0, 255, (12, 40, 3)).astype(np.uint8)
    Image.fromarray(small).resize((310, 94), Image.BICUBIC).save(
        root / "t.jpg", quality=90)
    return {"png": str(root / "g.png"), "jpg": str(root / "g.jpg"),
            "texture": str(root / "t.jpg"), "grad": grad, "root": root}


@pytest.mark.parametrize("route", ROUTES)
def test_decode_roundtrip_png(images, route):
    out = NL.get(route).decode(images["png"])
    assert out.dtype == np.float32 and out.shape == images["grad"].shape
    np.testing.assert_allclose(out, images["grad"] / 255.0, atol=1e-6)


@pytest.mark.parametrize("route", ROUTES)
def test_decode_roundtrip_jpeg(images, route):
    out = NL.get(route).decode(images["jpg"])
    assert out.shape == images["grad"].shape
    # lossy: the decode is near the source, not equal to it
    assert np.abs(out - images["grad"] / 255.0).mean() < 0.01
    assert NL.get(route).decode(str(images["root"] / "missing.jpg")) is None


@pytest.mark.parametrize("route", ROUTES)
def test_pyramid_against_pil(images, route):
    outs = NL.get(route).load_batch([images["png"]], 320, 96, num_scales=3)
    prev = Image.open(images["png"]).convert("RGB")
    for s in range(3):
        prev = prev.resize((320 >> s, 96 >> s), Image.Resampling.LANCZOS)
        pil = np.asarray(prev, np.float32) / 255.0
        diff = np.abs(outs[s][0] - pil)
        # float Lanczos against PIL's uint8-rounded fixed point
        assert diff.max() < 0.01, (s, diff.max())


@pytest.mark.parametrize("route", ROUTES)
def test_flip(images, route):
    loader = NL.get(route)
    plain = loader.load_batch([images["texture"]], 160, 48, 2)
    flipped = loader.load_batch([images["texture"]], 160, 48, 2,
                                flips=[True])
    for s in range(2):
        np.testing.assert_allclose(flipped[s][0], plain[s][0][:, ::-1],
                                   atol=1e-6)


@pytest.mark.parametrize("route", ROUTES)
def test_missing_file_fills_zeros(images, route):
    outs = NL.get(route).load_batch(
        [images["png"], str(images["root"] / "missing.png")], 320, 96, 2)
    for s in range(2):
        assert np.abs(outs[s][0]).sum() > 0
        np.testing.assert_array_equal(outs[s][1], 0.0)


def test_module_functions_use_the_host_route(images):
    """The JAX binding's module-level functions, on the host's route."""
    loader = NL.get()
    assert loader.route == native.loader_route() and NL.available()
    assert NL.jitter_available()
    paths = [images["jpg"], images["texture"]]
    got = NL.load_batch(paths, 64, 32, 2, [False, True], num_threads=2)
    want = loader.load_batch(paths, 64, 32, 2, [False, True])
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(NL.decode(images["png"]),
                                  loader.decode(images["png"]))


def test_load_batch_matches_the_jax_library(images, jax_lib):
    """Route a against the JAX package's library, both built here with the
    JAX Makefile's flags: PNG and JPEG, flips, four scales, a missing
    file; bit for bit."""
    paths = [images["png"], images["jpg"], images["texture"],
             str(images["root"] / "missing.jpg"), images["texture"]]
    flips = [False, True, False, False, True]
    got = NL.get("a").load_batch(paths, 128, 64, 4, flips, num_threads=3)
    want = jax_lib.load_batch(paths, 128, 64, 4, flips, num_threads=3)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for p in paths[:3]:
        np.testing.assert_array_equal(NL.get("a").decode(p),
                                      jax_lib.decode(p))


def test_jitter_batch_matches_the_jax_library(jax_lib):
    img = np.random.default_rng(7).uniform(
        0, 1, (3, 48, 64, 3)).astype(np.float32)
    for seed in range(6):
        params, ops = K.draw_jitter_params(np.random.default_rng(seed))
        jparams, jops = JK.draw_jitter_params(np.random.default_rng(seed))
        assert params == jparams and ops == jops
        got = NL.get("a").jitter_batch(img.copy(), params, ops)
        want = jax_lib.jitter_batch(img.copy(), params, ops)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("route", ROUTES)
def test_cpp_jitter_matches_numpy(route):
    """md_jitter_batch against the port's _apply_jitter_np, itself the JAX
    package's numpy jitter bit for bit: the same float math, so agreement
    is float rounding (the contrast mean sums in double in C++, pairwise
    in float32 in numpy)."""
    img = np.random.default_rng(7).uniform(
        0, 1, (3, 96, 128, 3)).astype(np.float32)
    for seed in range(12):  # most of the 24 op orders, and the factors
        params, ops = K.draw_jitter_params(np.random.default_rng(seed))
        ref = np.stack([K._apply_jitter_np(params, ops)(f) for f in img], 0)
        jax_ref = np.stack([JK._apply_jitter_np(params, ops)(f)
                            for f in img], 0)
        np.testing.assert_array_equal(ref, jax_ref)
        got = NL.get(route).jitter_batch(img.copy(), params, ops,
                                         num_threads=2)
        np.testing.assert_allclose(got, ref, atol=5e-6, rtol=0)


def test_cpp_jitter_keeps_a_zero_image_zero():
    """The blank-frame guard relies on jitter(0) == 0 exactly."""
    img = np.zeros((1, 32, 48, 3), np.float32)
    for seed in range(4):
        params, ops = K.draw_jitter_params(np.random.default_rng(seed))
        np.testing.assert_array_equal(
            NL.get().jitter_batch(img.copy(), params, ops), 0.0)


def test_color_jitter_np_matches_pil():
    """color_jitter_np against the PIL color_jitter on the same rng draw:
    PIL rounds to uint8 after every op and round-trips the hue through
    uint8 HSV, so they agree to that rounding."""
    small = np.random.default_rng(11).uniform(0, 255, (12, 16, 3))
    arr8 = np.repeat(np.repeat(small, 4, 0), 4, 1).astype(np.uint8)
    img = Image.fromarray(arr8)
    arrf = arr8.astype(np.float32) / 255.0
    for seed in range(8):
        out_pil = np.asarray(K.color_jitter(np.random.default_rng(seed))(img),
                             np.float32) / 255.0
        out_np = K.color_jitter_np(np.random.default_rng(seed))(arrf)
        diff = np.abs(out_pil - out_np)
        assert diff.max() < 0.08, (seed, diff.max())
        assert diff.mean() < 0.01, (seed, diff.mean())


def test_route_b_against_route_a(images):
    """Pillow's decoder against libjpeg and libpng: PNG is lossless, so
    equal; a JPEG decoder may round an IDCT differently, so the bound is
    one uint8 level in the decode and in each pyramid level (Lanczos
    weights sum to 1). Pillow 12.1's libjpeg-turbo and Debian 12's
    libjpeg62-turbo decoded these files to the same bytes."""
    a, b = NL.get("a"), NL.get("b")
    np.testing.assert_array_equal(b.decode(images["png"]),
                                  a.decode(images["png"]))
    level = 1.0 / 255.0 + 1e-6
    paths = [images["png"], images["jpg"], images["texture"]]
    for p in paths[1:]:
        assert np.abs(b.decode(p) - a.decode(p)).max() <= level
    flips = [True, False, True]
    got = b.load_batch(paths, 128, 64, 4, flips)
    want = a.load_batch(paths, 128, 64, 4, flips)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g[0], w[0])
        assert np.abs(g - w).max() <= level


def test_failed_build_raises_and_names_the_option(tmp_path, monkeypatch):
    """A compiler that exits 1: the dataset with native=True raises with
    the compiler's output and the hint; it does not read with PIL."""
    fake = tmp_path / "cxx"
    fake.write_text("#!/bin/sh\necho 'fake compiler: no such header' >&2\n"
                    "exit 1\n")
    fake.chmod(0o755)
    monkeypatch.setenv("CXX", str(fake))
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(NL.NativeLoaderUnavailable) as err:
        K.KITTIRawDataset(str(tmp_path), ["d 1 l"], 32, 64, (0, -1, 1),
                          native=True)
    assert "fake compiler: no such header" in str(err.value)
    assert "--no-native_loader" in str(err.value)
    assert not NL.available()
    assert list((tmp_path / "build").iterdir()) == []  # no temporary left
    ds = K.KITTIRawDataset(str(tmp_path), ["d 1 l"], 32, 64, (0, -1, 1),
                           native=False)
    assert ds.native is None


def test_concurrent_first_builds(tmp_path, monkeypatch):
    """Four threads build one route into an empty directory at once, as
    test workers do on a fresh checkout: each gets the one library."""
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    paths, errors = [], []

    def build():
        try:
            paths.append(native.build_loader("b"))
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
        assert not t.is_alive()
    assert not errors and len(set(paths)) == 1
    assert sorted(os.listdir(tmp_path)) == [paths[0].name]
