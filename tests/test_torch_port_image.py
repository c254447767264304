"""The port's image ops and image stages against the JAX package's.

The same seeded numpy images go through ``mmlspark_tpu.ops.image`` /
``mmlspark_tpu.image`` and ``mmlspark_tpu_torch.ops.image`` /
``mmlspark_tpu_torch.image`` (``device="cpu"``) on the CPU.

Tolerances: every op but resize within 1e-4 relative (max |port - jax| <=
1e-4 * max(1, max |jax|)): both compute the same float32 arithmetic, the
blur's convolutions only summing in another order. Resize within 1e-2 on a
0-255 scale: ``jax.image.resize``'s antialiased triangle filter and
``F.interpolate(antialias=True)`` compute the same weights in another
order (the worst case measured, 300 -> 224, is 3.4e-3).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu import image as J_image
from mmlspark_tpu.ops import image as J
from mmlspark_tpu_torch import DataFrame, load_stage
from mmlspark_tpu_torch import image as T_image
from mmlspark_tpu_torch.ops import image as T

OP_TOL = 1e-4
RESIZE_TOL = 1e-2


def _close(got, want, tol=OP_TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    assert float(np.abs(got.astype(np.float64) - want).max(initial=0.0)) <= tol * scale


def _images(shape, seed=0, dtype=np.uint8):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, size=shape)
    return x.astype(dtype)


@pytest.mark.parametrize("src,dst", [((256, 256), (224, 224)), ((300, 300), (224, 224)),
                                     ((32, 32), (224, 224)), ((48, 48), (32, 32)),
                                     ((40, 60), (17, 90)), ((32, 32), (32, 32))],
                         ids=["256to224", "300to224", "32to224", "48to32", "mixed", "same"])
def test_resize_matches_jax(src, dst):
    x = _images((2,) + src + (3,))
    want = J.resize(jnp.asarray(x), *dst)
    got = T.resize(torch.from_numpy(x), *dst)
    assert got.dtype == torch.float32
    _close(got, want, RESIZE_TOL / 255.0)  # the tolerance scale is max |jax| ~ 255


OPS = {
    "center_crop": (lambda m, x: m.center_crop(x, 5, 7), np.float32),
    "center_crop_oversize": (lambda m, x: m.center_crop(x, 20, 3), np.float32),
    "crop": (lambda m, x: m.crop(x, 1, 2, 3, 4), np.float32),
    "flip_h": (lambda m, x: m.flip(x, True), np.float32),
    "flip_v": (lambda m, x: m.flip(x, False), np.float32),
    "bgr_to_rgb": (lambda m, x: m.bgr_to_rgb(x), np.float32),
    "rgb_to_bgr_uint8": (lambda m, x: m.rgb_to_bgr(x), np.uint8),
    "gray_bgr": (lambda m, x: m.to_grayscale(x), np.float32),
    "gray_rgb_uint8": (lambda m, x: m.to_grayscale(x, bgr=False), np.uint8),
    "blur3": (lambda m, x: m.gaussian_blur(x, 3, 1.0), np.float32),
    "blur4_even": (lambda m, x: m.gaussian_blur(x, 4, 1.5), np.float32),
    "blur5_uint8": (lambda m, x: m.gaussian_blur(x, 5, 2.0), np.uint8),
    "threshold": (lambda m, x: m.threshold(x, 128.0, 255.0), np.float32),
    "threshold_uint8": (lambda m, x: m.threshold(x, 100.0, 1.0), np.uint8),
    "unroll": (lambda m, x: m.unroll(x), np.float32),
    "unroll_no_bgr": (lambda m, x: m.unroll(x, bgr=False), np.uint8),
    "normalize": (lambda m, x: m.normalize(x), np.float32),
    "normalize_uint8": (lambda m, x: m.normalize(x), np.uint8),
    "normalize_custom": (lambda m, x: m.normalize(x, (0.5, 0.5, 0.5), (0.2, 0.3, 0.4), 1 / 127.5),
                         np.float32),
}


@pytest.mark.parametrize("name", sorted(OPS))
def test_op_matches_jax(name):
    fn, dtype = OPS[name]
    x = _images((2, 9, 11, 3), seed=1, dtype=dtype)
    _close(fn(T, torch.from_numpy(x)), fn(J, jnp.asarray(x)))


@pytest.mark.parametrize("bgr", [True, False])
def test_roll_inverts_unroll_like_jax(bgr):
    x = _images((3, 6, 5, 3), seed=2, dtype=np.float32)
    v = np.array(J.unroll(jnp.asarray(x), bgr))
    got = T.roll(torch.from_numpy(v), 6, 5, bgr=bgr)
    _close(got, J.roll(jnp.asarray(v), 6, 5, bgr=bgr))
    np.testing.assert_array_equal(got.numpy(), x)


@pytest.mark.parametrize("ksize,sigma", [(3, 1.0), (4, 0.7), (7, 2.5)])
def test_gaussian_kernel_matches_jax(ksize, sigma):
    _close(T.gaussian_kernel(ksize, sigma), J.gaussian_kernel(ksize, sigma))


def _ppm(h, w, seed):
    img = _images((h, w, 3), seed=seed)
    return b"P6\n%d %d\n255\n" % (w, h) + img.tobytes(), img


@pytest.mark.parametrize("pil", [True, False], ids=["pil", "ppm_fallback"])
def test_decode_image_matches_jax(pil, monkeypatch):
    blob, img = _ppm(5, 7, seed=3)
    if not pil:  # the card machine may lack PIL: the fallback decodes PPM
        import builtins

        real = builtins.__import__

        def no_pil(name, *a, **k):
            if name == "PIL" or name.startswith("PIL."):
                raise ImportError(name)
            return real(name, *a, **k)

        monkeypatch.setattr(builtins, "__import__", no_pil)
    for data in (blob, b"not-an-image"):
        want, got = J.decode_image(data), T.decode_image(data)
        if want is None:
            assert got is None
        else:
            np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(T.decode_image(blob), img)


# -- stages -------------------------------------------------------------------


def _obj_images(shapes, seed=0):
    rng = np.random.RandomState(seed)
    imgs = np.empty(len(shapes), dtype=object)
    for i, (h, w) in enumerate(shapes):
        imgs[i] = (rng.rand(h, w, 3) * 255).astype(np.float32)
    return imgs


def _both(col, **extra):
    data = {"image": col, "id": np.arange(len(col)), **extra}
    return JDataFrame.from_dict(data), DataFrame.from_dict(data)


def _col_close(got, want, tol=OP_TOL):
    assert len(got) == len(want)
    if want.dtype == object:
        assert got.dtype == object
        for g, w in zip(got, want):
            _close(g, w, tol)
    else:
        _close(got, want, tol)


def _fluent(mod, build):
    return build(mod.ImageTransformer())


TRANSFORMS = {
    "resize_flip": lambda t: t.resize(8, 8).flip(),
    "flip_vertical": lambda t: t.flip(0),
    "crop": lambda t: t.crop(2, 4, 8, 6),
    "gray": lambda t: t.color_format("gray"),
    "bgr2rgb": lambda t: t.color_format("bgr2rgb"),
    "threshold": lambda t: t.threshold(128.0, 255.0),
    "blur": lambda t: t.blur(5, 2.0),
    "gaussian_kernel": lambda t: t.gaussian_kernel(3, 1.0),
    "normalize": lambda t: t.resize(10, 10).normalize(),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
@pytest.mark.parametrize("layout", ["mixed_shapes", "dense"])
def test_image_transformer_matches_jax(name, layout):
    build = TRANSFORMS[name]
    if layout == "dense":
        col = np.stack(list(_obj_images([(16, 16)] * 3, seed=4)))
    else:
        col = _obj_images([(16, 16), (20, 12), (16, 16)], seed=4)
    jdf, tdf = _both(col)
    want = _fluent(J_image, build).transform(jdf)["image"]
    stage = _fluent(T_image, build).set(device="cpu")
    got = stage.transform(tdf)["image"]
    tol = RESIZE_TOL / 255.0 if name.startswith(("resize", "normalize")) else OP_TOL
    _col_close(got, want, tol)
    assert stage.get("stages") == _fluent(J_image, build).get("stages")


def test_image_transformer_save_load(tmp_path):
    t = T_image.ImageTransformer(device="cpu").resize(8, 8).blur(3, 1.0)
    t.save(str(tmp_path / "it"))
    t2 = load_stage(str(tmp_path / "it"))
    _, df = _both(_obj_images([(10, 10)]))
    np.testing.assert_array_equal(t.transform(df)["image"][0], t2.transform(df)["image"][0])


def test_image_transformer_unknown_op():
    with pytest.raises(ValueError):
        T_image.ImageTransformer(device="cpu").color_format("hsv").transform(
            _both(_obj_images([(4, 4)]))[1])


@pytest.mark.parametrize("shapes", [[(32, 16), (8, 24)], [(6, 6), (6, 6)]], ids=["mixed", "uniform"])
def test_resize_transformer_matches_jax(shapes):
    jdf, tdf = _both(_obj_images(shapes, seed=5))
    want = J_image.ResizeImageTransformer(height=10, width=12).transform(jdf)["image"]
    got = T_image.ResizeImageTransformer(height=10, width=12, device="cpu").transform(tdf)["image"]
    _col_close(got, want, RESIZE_TOL / 255.0)


@pytest.mark.parametrize("bgr", [True, False])
@pytest.mark.parametrize("shapes", [[(6, 6), (6, 6)], [(4, 4), (3, 5)]], ids=["uniform", "mixed"])
def test_unroll_image_matches_jax(shapes, bgr):
    jdf, tdf = _both(_obj_images(shapes, seed=6))
    want = J_image.UnrollImage(bgr=bgr).transform(jdf)["unrolled"]
    got = T_image.UnrollImage(bgr=bgr, device="cpu").transform(tdf)["unrolled"]
    _col_close(got, want)


def test_unroll_binary_image_matches_jax():
    blobs = np.empty(3, dtype=object)
    blobs[0], _ = _ppm(4, 4, seed=7)
    blobs[1] = b"garbage"
    blobs[2], _ = _ppm(4, 4, seed=8)
    jdf, tdf = _both(blobs)
    want = J_image.UnrollBinaryImage().transform(jdf)["unrolled"]
    got = T_image.UnrollBinaryImage(device="cpu").transform(tdf)["unrolled"]
    _col_close(got, want)


@pytest.mark.parametrize("lr,ud", [(True, False), (True, True), (False, True)])
def test_augmenter_matches_jax(lr, ud):
    jdf, tdf = _both(_obj_images([(8, 8), (6, 10)], seed=9))
    want = J_image.ImageSetAugmenter(flip_left_right=lr, flip_up_down=ud).transform(jdf)
    got = T_image.ImageSetAugmenter(flip_left_right=lr, flip_up_down=ud,
                                    device="cpu").transform(tdf)
    assert got.count() == want.count()
    assert got["id"].tolist() == want["id"].tolist()
    _col_close(got["image"], want["image"])


def test_stages_default_to_the_card():
    _, df = _both(_obj_images([(4, 4)]))
    stage = T_image.ImageTransformer().flip()
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        stage.transform(df)
