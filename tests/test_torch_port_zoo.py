"""The port's zoo, checkpoint formats, TorchModel and ImageFeaturizer
against the JAX package's.

- ``flax_msgpack`` reads both packaged checkpoints as
  ``flax.serialization.msgpack_restore`` does and writes the bytes
  ``msgpack_serialize`` writes (exactly equal);
- the packaged copies are byte-equal to the JAX package's files;
- ``import_torch_resnet`` returns the JAX importer's tree (exactly equal),
  with the same strictness errors;
- a zoo written by either package loads in the other;
- ``TorchModel`` pads, selects and persists as XLAModel does;
- ``ImageFeaturizer`` on the packaged checkpoints against the JAX
  featurizer.

Tolerances: the featurizers compute in bf16 in both packages, with the same
rounding points; XLA fuses the float32 normalisation differently, so a
network input may sit one bf16 ulp away, and the features are held to a
relative L2 of 2e-2 (measured: under 8e-3). In float32 (the module and
apply_fn overrides) features are held to 1e-3 relative, the resize's
float32 differences (1e-2 on 0-255, see test_torch_port_image.py) carried
through the network.
"""

from __future__ import annotations

import hashlib
import json
import os
import sys
import threading
from dataclasses import asdict
from functools import partial
from http.server import HTTPServer, SimpleHTTPRequestHandler

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization as fser

from mmlspark_tpu import DataFrame as JDataFrame
from mmlspark_tpu.core.schema import make_image_row
from mmlspark_tpu.downloader import import_torch_resnet as j_import_torch_resnet
from mmlspark_tpu.downloader.zoo import PACKAGED_DIR as J_PACKAGED_DIR
from mmlspark_tpu.downloader.zoo import ModelDownloader as JModelDownloader
from mmlspark_tpu.downloader.zoo import ModelSchema as JModelSchema
from mmlspark_tpu.models import ImageFeaturizer as JImageFeaturizer
from mmlspark_tpu.models import XLAModel
from mmlspark_tpu.models.resnet import init_resnet
from mmlspark_tpu.models.resnet import resnet18 as j_resnet18
from mmlspark_tpu_torch import DataFrame, load_stage
from mmlspark_tpu_torch.downloader import (
    ModelDownloader,
    ModelSchema,
    RemoteRepository,
    flax_msgpack,
    import_torch_resnet,
    install_torch_checkpoint,
)
from mmlspark_tpu_torch.downloader.zoo import PACKAGED_DIR
from mmlspark_tpu_torch.models import ImageFeaturizer, TorchModel
from mmlspark_tpu_torch.models import resnet as TR

sys.path.insert(0, os.path.dirname(__file__))
from test_torch_import import (  # noqa: E402  the torchvision-layout ResNet
    _randomize_bn_stats,
    _TorchBasic,
    _TorchBottleneck,
    _TorchResNet,
)
from test_zoo_weights import load_digits_images  # noqa: E402

BF16_L2 = 2e-2
F32_REL = 1e-3
PACKAGED = ("ResNet8_Digits", "ResNet18_Patches")


def _tree_equal(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _tree_equal(a[k], b[k])
    elif isinstance(a, list):
        assert isinstance(b, list) and len(a) == len(b)
        for x, y in zip(a, b):
            _tree_equal(x, y)
    else:
        assert type(a) is type(b), (type(a), type(b))
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# -- flax's msgpack ------------------------------------------------------------


@pytest.mark.parametrize("name", PACKAGED)
def test_msgpack_reads_and_writes_the_packaged_checkpoints_as_flax(name):
    with open(os.path.join(PACKAGED_DIR, f"{name}.msgpack"), "rb") as f:
        blob = f.read()
    tree = flax_msgpack.msgpack_restore(blob)
    _tree_equal(tree, fser.msgpack_restore(blob))
    assert flax_msgpack.msgpack_serialize(tree) == blob


def _trees():
    rng = np.random.default_rng(0)
    return {
        "f16": {"w": rng.normal(size=(3, 4)).astype(np.float16), "b": np.zeros(0, np.float16)},
        "scalars": {"a": np.float32(1.5), "b": np.int64(-7), "c": np.bool_(True),
                    "d": np.zeros((), np.float64), "e": np.uint8(200)},
        "nested": {"z": {"y": {"x": rng.normal(size=(2, 2, 2)).astype(np.float32)}},
                   "a": [1, -1, 200, -200, 70000, -70000, 2**40, -2**40, 2**63, 3.25, True,
                         None, "s" * 40, "é", b"bin" * 100, {"k": np.arange(300)}],
                   **{f"k{i}": np.arange(i, dtype=np.int32) for i in range(20)}},
        "big_arrays": {"u8": rng.integers(0, 255, 70000).astype(np.uint8),
                       "f64": rng.normal(size=(300, 301))},
    }


@pytest.mark.parametrize("case", sorted(_trees()))
def test_msgpack_writes_flax_bytes(case):
    tree = _trees()[case]
    blob = fser.msgpack_serialize(tree)
    assert flax_msgpack.msgpack_serialize(tree) == blob
    _tree_equal(flax_msgpack.msgpack_restore(blob), fser.msgpack_restore(blob))


def test_msgpack_chunked_arrays_as_flax(monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes travel as flax's chunk maps (the
    limit lowered here so a small array crosses it)."""
    import flax.serialization as fs_mod

    monkeypatch.setattr(fs_mod, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"p": {"w": np.arange(100, dtype=np.float32).reshape(10, 10), "s": np.ones(3)}}
    blob = fser.msgpack_serialize(tree)
    assert flax_msgpack.msgpack_serialize(tree) == blob
    _tree_equal(flax_msgpack.msgpack_restore(blob), fser.msgpack_restore(blob))


def test_msgpack_refuses_what_flax_refuses():
    with pytest.raises(TypeError):
        flax_msgpack.msgpack_serialize({"t": (1, 2)})
    with pytest.raises(ValueError):
        flax_msgpack.msgpack_restore(fser.msgpack_serialize({"a": 1})[:-1])


@pytest.mark.parametrize("name", PACKAGED)
def test_packaged_copies_equal_the_jax_package_files(name):
    for suffix in (".msgpack", ".schema.json"):
        with open(os.path.join(PACKAGED_DIR, name + suffix), "rb") as f:
            ours = f.read()
        with open(os.path.join(J_PACKAGED_DIR, name + suffix), "rb") as f:
            theirs = f.read()
        assert hashlib.sha256(ours).hexdigest() == hashlib.sha256(theirs).hexdigest()
    schema = json.loads(ours)
    with open(os.path.join(PACKAGED_DIR, name + ".msgpack"), "rb") as f:
        assert hashlib.sha256(f.read()).hexdigest() == schema["sha256"]


# -- torchvision import ----------------------------------------------------------


def _torchvision_state(variant, seed, num_classes=16):
    block, stages = {"ResNet18": (_TorchBasic, [2, 2, 2, 2]),
                     "ResNet50": (_TorchBottleneck, [3, 4, 6, 3])}[variant]
    torch.manual_seed(seed)
    tm = _TorchResNet(block, stages, num_classes=num_classes)
    _randomize_bn_stats(tm, seed + 1)
    return tm.eval()


@pytest.mark.parametrize("variant", ["ResNet18", "ResNet50"])
def test_import_torch_resnet_equals_the_jax_importer(variant):
    sd = _torchvision_state(variant, seed=0).state_dict()
    _tree_equal(import_torch_resnet(sd, variant), j_import_torch_resnet(sd, variant))


def test_imported_weights_reproduce_torchvision_features():
    tm = _torchvision_state("ResNet18", seed=1)
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    with torch.no_grad():
        ref = tm(torch.from_numpy(x.transpose(0, 3, 1, 2)))
    ours = TR.load_flax_variables(
        TR.resnet18(num_classes=16, dtype=torch.float32, torch_padding=True),
        import_torch_resnet(tm.state_dict(), "ResNet18")).eval()
    with torch.inference_mode():
        out = ours(torch.from_numpy(x))
    for k in ("layer3", "pool", "logits"):
        want = ref[k].numpy()
        got = out[k].numpy().transpose(0, 3, 1, 2) if out[k].ndim == 4 else out[k].numpy()
        assert float(np.abs(got - want).max()) <= 1e-4 * float(np.abs(want).max()), k


@pytest.mark.parametrize("importer", ["port", "jax"])
def test_import_rejects_architecture_mismatch_as_jax(importer):
    fn = import_torch_resnet if importer == "port" else j_import_torch_resnet
    tm = _TorchResNet(_TorchBasic, [2, 2, 2, 2])
    with pytest.raises(ValueError, match="missing 'layer1.0.conv3.weight'"):
        fn(tm.state_dict(), variant="ResNet50")
    sd = tm.state_dict()
    sd["layer1.0.extra.weight"] = torch.zeros(1)
    with pytest.raises(ValueError, match=r"unconsumed keys .*layer1\.0\.extra\.weight"):
        fn(sd, variant="ResNet18")


def test_vit_raises_naming_the_roadmap_item(tmp_path):
    with pytest.raises(NotImplementedError, match="item 9"):
        import_torch_resnet({}, "ViTB16")
    with pytest.raises(NotImplementedError, match="item 9"):
        install_torch_checkpoint({}, name="ViTB16_x", downloader=ModelDownloader(str(tmp_path)))
    with pytest.raises(NotImplementedError, match="item 9"):
        ModelDownloader(str(tmp_path)).load("ViTTiny", device="cpu")


def test_install_torch_checkpoint_loads_in_both_packages(tmp_path):
    tm = _torchvision_state("ResNet18", seed=3, num_classes=12)
    pth = tmp_path / "r18.pth"
    torch.save(tm.state_dict(), pth)
    repo = str(tmp_path / "zoo")
    schema = install_torch_checkpoint(str(pth), name="ResNet18_Imported", image_size=64,
                                      downloader=ModelDownloader(repo))
    assert schema.torch_padding and schema.num_classes == 12
    _, variables, jschema = JModelDownloader(repo).load("ResNet18_Imported")
    assert jschema.torch_padding
    _tree_equal(variables, fser.msgpack_restore(
        fser.msgpack_serialize(j_import_torch_resnet(tm.state_dict(), "ResNet18"))))


# -- the zoo ------------------------------------------------------------------------


def test_zoo_written_by_jax_loads_in_the_port(tmp_path):
    repo = str(tmp_path / "zoo")
    _, variables = init_resnet("ResNet18", num_classes=10, image_size=32, small_inputs=True,
                               num_filters=8, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.random.default_rng(0).normal(size=a.shape).astype(np.float32)
        * 0.05, variables)
    JModelDownloader(repo).register(
        JModelSchema(name="TinyJax", variant="ResNet18", num_classes=10, image_size=32,
                     small_inputs=True, num_filters=8), variables)
    _, got_vars, schema = ModelDownloader(repo).load("TinyJax", device="cpu")
    assert schema.num_filters == 8 and "TinyJax" in ModelDownloader(repo).list_models()
    _tree_equal(got_vars, jax.tree_util.tree_map(np.asarray, variables))
    module = TR.load_flax_variables(
        TR.resnet18(num_classes=10, small_inputs=True, num_filters=8, dtype=torch.float32),
        got_vars).eval()
    x = np.random.default_rng(1).normal(size=(2, 32, 32, 3)).astype(np.float32)
    want = j_resnet18(num_classes=10, small_inputs=True, num_filters=8,
                      dtype=jnp.float32).apply(variables, jnp.asarray(x), train=False)
    with torch.inference_mode():
        out = module(torch.from_numpy(x))
    for k in ("pool", "logits"):
        a = np.asarray(want[k])
        assert float(np.abs(out[k].numpy() - a).max()) <= 1e-4 * float(np.abs(a).max())


def test_zoo_written_by_the_port_loads_in_jax(tmp_path, caplog):
    repo = str(tmp_path / "zoo")
    schema = ModelSchema(name="TinyPort", variant="ResNet18", num_classes=4, image_size=32,
                         small_inputs=True, num_filters=8)
    module = TR.resnet18(num_classes=4, small_inputs=True, num_filters=8, dtype=torch.float32)
    variables = TR.init_flax_variables(module, seed=3)
    ModelDownloader(repo).register(schema, variables)
    _, jvars, jschema = JModelDownloader(repo).load("TinyPort")
    assert jschema.sha256 == schema.sha256
    # flax writes dicts in sorted key order: compare through our own reader
    _tree_equal(jax.tree_util.tree_map(np.asarray, jvars),
                flax_msgpack.msgpack_restore(flax_msgpack.msgpack_serialize(variables)))
    # a seeded init for a schema with no checkpoint: the loud warning, the
    # JAX package's layout, and the same bytes for the same seed
    dl = ModelDownloader(str(tmp_path / "seeded"))
    with caplog.at_level("WARNING"):
        s1 = dl.download_by_name("ResNet18")
    assert "SEEDED RANDOM init" in caplog.text
    _, jv, _ = JModelDownloader(str(tmp_path / "seeded")).load("ResNet18")
    want = init_resnet("ResNet18", image_size=32)[1]
    assert jax.tree_util.tree_structure(jv) == jax.tree_util.tree_structure(want)
    dl2 = ModelDownloader(str(tmp_path / "seeded2"))
    assert dl2.download_by_name("ResNet18").sha256 == s1.sha256


def test_zoo_widens_f16_and_checks_sha(tmp_path):
    dl = ModelDownloader(str(tmp_path))
    variables, schema = dl.load_variables("ResNet18_Patches")
    leaves = jax.tree_util.tree_leaves(variables)
    assert leaves and all(a.dtype == np.float32 for a in leaves)
    with open(os.path.join(PACKAGED_DIR, "ResNet18_Patches.msgpack"), "rb") as f:
        raw = fser.msgpack_restore(f.read())
    assert jax.tree_util.tree_leaves(raw)[0].dtype == np.float16
    with pytest.raises(KeyError):
        dl.download_by_name("NoSuchNet")
    _, wpath = dl._paths("ResNet8_Digits")
    dl.download_by_name("ResNet8_Digits")
    with open(wpath, "ab") as f:
        f.write(b"x")
    with pytest.raises(IOError, match="checksum"):
        dl.load_variables("ResNet8_Digits")


def test_remote_repository_sync_from_local_http(tmp_path):
    remote_dir = tmp_path / "remote"
    remote_dir.mkdir()
    weights = {"params": {"w": np.arange(6, dtype=np.float32).reshape(2, 3)}}
    blob = flax_msgpack.msgpack_serialize(weights)
    (remote_dir / "TinyNet.msgpack").write_bytes(blob)
    schema = ModelSchema(name="TinyNet", variant="ResNet18",
                         sha256=hashlib.sha256(blob).hexdigest())
    (remote_dir / "index.json").write_text(json.dumps([asdict(schema)]))
    (remote_dir / "Bad.msgpack").write_bytes(b"tampered")
    handler = partial(SimpleHTTPRequestHandler, directory=str(remote_dir))
    srv = HTTPServer(("127.0.0.1", 0), handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        local = ModelDownloader(str(tmp_path / "local"))
        repo = RemoteRepository(f"http://127.0.0.1:{srv.server_port}", local)
        assert [s.name for s in repo.list_models()] == ["TinyNet"]
        assert repo.sync()[0].sha256 == schema.sha256
        _, wpath = local._paths("TinyNet")
        with open(wpath, "rb") as f:
            got = fser.msgpack_restore(f.read())
        np.testing.assert_array_equal(got["params"]["w"], weights["params"]["w"])
        with pytest.raises(IOError):
            repo.download(ModelSchema(name="Bad", sha256="0" * 64))
    finally:
        srv.shutdown()


# -- TorchModel -----------------------------------------------------------------------


def _double(vs, x):
    return (x @ vs["w"]) * 2


class _Twice(torch.nn.Module):
    def forward(self, x):
        return {"a": x * 2, "b": x * 3}


@pytest.mark.parametrize("form", ["apply_fn", "module"])
@pytest.mark.parametrize("n,bs", [(10, 8), (5, 4), (3, 64), (0, 4)])
def test_torch_model_pads_and_selects_like_xla_model(form, n, bs):
    x = np.random.default_rng(0).normal(size=(n, 4)).astype(np.float32)
    j = XLAModel(input_col="x", output_col="y", batch_size=bs, output_node="b")
    j.set(apply_fn=lambda vs, v: {"a": v @ vs["w"], "b": (v @ vs["w"]) * 3},
          variables={"w": np.eye(4, dtype=np.float32)})
    t = TorchModel(input_col="x", output_col="y", batch_size=bs, output_node="b", device="cpu")
    if form == "module":
        t.set(module=_Twice())
    else:
        t.set(apply_fn=lambda vs, v: {"a": v @ vs["w"], "b": (v @ vs["w"]) * 3},
              variables={"w": np.eye(4, dtype=np.float32)})
    want = j.transform(JDataFrame.from_dict({"x": x}, num_partitions=2 if n > 4 else 1))["y"]
    got = t.transform(DataFrame.from_dict({"x": x}, num_partitions=2 if n > 4 else 1))["y"]
    assert got.shape == want.shape  # (0,) for no rows in both DataFrames
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert t.apply_batch(x).shape == j.apply_batch(x).shape == (n, 4)


def test_torch_model_pads_to_a_fixed_batch():
    seen = []

    def fn(vs, x):
        seen.append(tuple(x.shape))
        return x + vs["b"]

    t = TorchModel(input_col="x", output_col="y", batch_size=4, device="cpu", apply_fn=fn,
                   variables={"b": np.ones(3, np.float32)})
    out = t.apply_batch(np.zeros((6, 3), np.float32))
    assert seen == [(4, 3), (4, 3)] and out.shape == (6, 3)
    np.testing.assert_array_equal(out, 1.0)


def test_torch_model_needs_output_node_for_dicts():
    t = TorchModel(input_col="x", output_col="y", device="cpu", module=_Twice())
    with pytest.raises(ValueError, match="output_node"):
        t.apply_batch(np.ones((2, 2), np.float32))


@pytest.mark.parametrize("form", ["apply_fn", "module"])
def test_torch_model_save_load(tmp_path, form):
    df = DataFrame.from_dict({"x": np.ones((4, 4), np.float32)})
    m = TorchModel(input_col="x", output_col="y", batch_size=4, device="cpu")
    if form == "module":
        lin = torch.nn.Linear(4, 4, bias=False)
        torch.nn.init.eye_(lin.weight)
        m.set(module=torch.nn.Sequential(lin, torch.nn.Identity()), input_dtype="float32")
        want = 1.0
    else:
        m.set(apply_fn=_double, variables={"w": np.eye(4, dtype=np.float32)})
        want = 2.0
    m.save(str(tmp_path / "m"))
    m2 = TorchModel.load(str(tmp_path / "m"))
    np.testing.assert_allclose(m2.transform(df)["y"], want)
    assert load_stage(str(tmp_path / "m")).get("batch_size") == 4


def test_torch_model_keeps_uint8_on_the_wire():
    seen = []

    def fn(vs, x):
        seen.append(x.dtype)
        return x.float()

    t = TorchModel(input_col="x", output_col="y", device="cpu", apply_fn=fn, variables={},
                   input_dtype=None)
    t.apply_batch(np.ones((2, 3), np.uint8))
    assert seen == [torch.uint8]


@pytest.mark.parametrize("entry", ["torch_model", "featurizer", "zoo", "transformer"])
def test_entry_points_default_to_the_card(entry, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    x = np.zeros((2, 32, 32, 3), np.uint8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        if entry == "torch_model":
            TorchModel(input_col="x", output_col="y", apply_fn=_double,
                       variables={"w": np.eye(3)}).apply_batch(x)
        elif entry == "featurizer":
            ImageFeaturizer(input_col="image", output_col="f", repo_dir=str(tmp_path)).transform(
                DataFrame.from_dict({"image": x}))
        elif entry == "zoo":
            ModelDownloader(str(tmp_path)).load("ResNet8_Digits")
        else:
            from mmlspark_tpu_torch.image import UnrollImage

            UnrollImage().transform(DataFrame.from_dict({"image": x}))


# -- ImageFeaturizer --------------------------------------------------------------------


@pytest.fixture(scope="module")
def digits():
    imgs, y = load_digits_images()
    return imgs[1500:1564], y[1500:1564]


def _featurize(pkg, df_rows, tmp_path, **kw):
    if pkg == "jax":
        f = JImageFeaturizer(input_col="image", output_col="f", repo_dir=str(tmp_path / "j"), **kw)
        return f.transform(JDataFrame.from_dict(df_rows))
    f = ImageFeaturizer(input_col="image", output_col="f", repo_dir=str(tmp_path / "t"),
                        device="cpu", **kw)
    return f.transform(DataFrame.from_dict(df_rows))


@pytest.mark.parametrize("cut", [0, 1, 2], ids=["logits", "pool", "layer3"])
def test_featurizer_matches_jax_on_the_digits_checkpoint(cut, digits, tmp_path):
    imgs, _ = digits
    rows = {"image": imgs}
    want = _featurize("jax", rows, tmp_path, cut_output_layers=cut, batch_size=16)["f"]
    got = _featurize("torch", rows, tmp_path, cut_output_layers=cut, batch_size=16)["f"]
    assert got.shape == want.shape and got.dtype == np.float32
    assert _rel_l2(got, want) <= BF16_L2


def test_featurizer_logits_classify_the_held_out_digits(tmp_path):
    imgs, y = load_digits_images()
    f = ImageFeaturizer(input_col="image", output_col="logits", repo_dir=str(tmp_path),
                        cut_output_layers=0, device="cpu")
    assert f.get("model_name") == "ResNet8_Digits"
    logits = f.transform(DataFrame.from_dict({"image": imgs[1500:]}))["logits"]
    assert logits.shape == (len(y) - 1500, 10)
    assert (logits.argmax(-1) == y[1500:]).mean() > 0.95


def test_featurizer_matches_jax_on_the_patches_checkpoint(tmp_path):
    rng = np.random.default_rng(5)
    imgs = rng.integers(0, 255, size=(8, 40, 40, 3), dtype=np.uint8)
    kw = dict(model_name="ResNet18_Patches", cut_output_layers=1, image_size=32, batch_size=8)
    want = _featurize("jax", {"image": imgs}, tmp_path, **kw)["f"]
    got = _featurize("torch", {"image": imgs}, tmp_path, **kw)["f"]
    assert got.shape == want.shape == (8, 256) and got.dtype == np.float32
    assert _rel_l2(got, want) <= BF16_L2


@pytest.mark.parametrize("layout", ["structs", "unrolled", "unrolled_bgr", "bgr", "float"])
def test_featurizer_input_layouts_match_jax(layout, digits, tmp_path):
    imgs = digits[0][:12]
    kw = dict(batch_size=8)
    if layout == "structs":
        col = np.empty(len(imgs), dtype=object)
        for i, im in enumerate(imgs):
            col[i] = make_image_row(im)
    elif layout.startswith("unrolled"):
        # the reference's layout: BGR planes, CHW
        planes = imgs[..., ::-1].transpose(0, 3, 1, 2)
        col = np.ascontiguousarray(planes.reshape(len(imgs), -1))
        kw.update(image_size=32, bgr_input=layout == "unrolled_bgr")
    elif layout == "bgr":
        col, kw["bgr_input"] = np.ascontiguousarray(imgs[..., ::-1]), True
    else:
        col = imgs.astype(np.float32) + 0.25
    want = _featurize("jax", {"image": col}, tmp_path, **kw)["f"]
    got = _featurize("torch", {"image": col}, tmp_path, **kw)["f"]
    assert got.shape == want.shape == (len(imgs), 64)
    assert _rel_l2(got, want) <= BF16_L2


def test_featurizer_drops_bad_rows_as_jax(digits, tmp_path):
    good = make_image_row(digits[0][0])
    col = np.empty(4, dtype=object)
    col[:] = [good, b"not-an-image", None, good]
    rows = {"image": col, "id": np.arange(4)}
    want = _featurize("jax", rows, tmp_path)
    got = _featurize("torch", rows, tmp_path)
    assert got.count() == want.count() == 2
    assert got["id"].tolist() == want["id"].tolist() == [0, 3]
    assert _rel_l2(got["f"], want["f"]) <= BF16_L2
    with pytest.raises(ValueError, match="drop_na"):
        _featurize("torch", rows, tmp_path, drop_na=False)


def test_featurizer_overrides_match_jax_in_f32(tmp_path):
    """A float32 backbone through both override forms (the port's module
    override, the JAX and the port's apply_fn override), resized 48 -> 32."""
    _, variables = init_resnet("ResNet18", num_classes=6, image_size=32, small_inputs=True,
                               num_filters=8, dtype=jnp.float32)
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + np.random.default_rng(0).normal(size=a.shape).astype(np.float32)
        * 0.05, variables)
    fm = j_resnet18(num_classes=6, small_inputs=True, num_filters=8, dtype=jnp.float32)
    imgs = np.random.default_rng(1).integers(0, 255, size=(6, 48, 48, 3), dtype=np.uint8)
    want = JImageFeaturizer(
        input_col="image", output_col="f", image_size=32, batch_size=4,
        apply_fn=lambda vs, x: fm.apply(vs, x, train=False), variables=variables,
    ).transform(JDataFrame.from_dict({"image": imgs}))["f"]
    tm = TR.load_flax_variables(
        TR.resnet18(num_classes=6, small_inputs=True, num_filters=8, dtype=torch.float32),
        variables)
    by_module = ImageFeaturizer(input_col="image", output_col="f", image_size=32, batch_size=4,
                                module=tm, device="cpu")
    by_fn = ImageFeaturizer(input_col="image", output_col="f", image_size=32, batch_size=4,
                            apply_fn=lambda vs, x: tm(x), variables={}, device="cpu")
    for f in (by_module, by_fn):
        got = f.transform(DataFrame.from_dict({"image": imgs}))["f"]
        assert got.shape == want.shape == (6, 64)
        assert float(np.abs(got - want).max()) <= F32_REL * float(np.abs(want).max())


def test_featurizer_bad_cut_and_fusion(tmp_path):
    f = ImageFeaturizer(input_col="image", output_col="f", repo_dir=str(tmp_path),
                        cut_output_layers=6, device="cpu")
    with pytest.raises(ValueError, match="cut_output_layers"):
        f.transform(DataFrame.from_dict({"image": np.zeros((1, 32, 32, 3), np.uint8)}))
    k = ImageFeaturizer(input_col="image", output_col="f", repo_dir=str(tmp_path),
                        device="cpu").fusable_kernel()
    assert (k.reads, k.writes, k.exact_capable) == (("image",), ("f",), False)
    assert k.guard({"image": np.zeros((2, 8), np.uint8)}) is not None  # unrolled: host path
    assert ImageFeaturizer(input_col="a", output_col="b").pipeline_io() == (("a",), ("b",))


# -- flax's seeded init ------------------------------------------------------------------

# XLA's and PyTorch's f32 log1p (inside erf_inv) round differently in ~9%
# of inputs: the port's draws are within 4 ulp of flax's, and at least 98%
# of all values bitwise equal (measured: 99.1%, at most 4 ulp)
INIT_ULP, INIT_BITWISE = 4, 0.98


@pytest.mark.parametrize("variant,kw,size", [
    ("ResNet8", dict(num_classes=10, small_inputs=True, num_filters=16), 32),
    ("ResNet18", dict(num_classes=10, small_inputs=True, num_filters=64), 32),
    ("ResNet50", dict(num_classes=1000), 224),
], ids=["resnet8", "resnet18", "resnet50"])
def test_seeded_init_equals_flax(variant, kw, size):
    """``init_flax_variables(module, seed)`` gives flax's
    ``model.init(PRNGKey(seed))`` numbers (the JAX package's
    ``init_resnet``), ResNet-50 at full width."""
    _, want = init_resnet(variant, image_size=size, seed=5, **kw)
    got = TR.init_flax_variables(TR.RESNETS[variant](**kw), seed=5)
    fa = jax.tree_util.tree_flatten_with_path(want)[0]
    fb = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [p for p, _ in fa] == [p for p, _ in fb]
    same = total = 0
    for (path, a), (_, b) in zip(fa, fb):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype == np.float32, path
        ulp = np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
        assert int(ulp.max()) <= INIT_ULP, path
        same += int((a == b).sum())
        total += a.size
    assert same / total >= INIT_BITWISE


def test_seeded_resnet50_features_equal_the_jax_package(tmp_path):
    """No checkpoint covers ResNet-50: both zoos materialise the seeded
    init, and both featurizers give the same pool features (bf16)."""
    rng = np.random.default_rng(0)
    imgs = rng.integers(0, 255, size=(2, 224, 224, 3), dtype=np.uint8)
    kw = dict(model_name="ResNet50", cut_output_layers=1, batch_size=2)
    want = _featurize("jax", {"image": imgs}, tmp_path, **kw)["f"]
    got = _featurize("torch", {"image": imgs}, tmp_path, **kw)["f"]
    assert got.shape == want.shape == (2, 2048)
    assert _rel_l2(got, want) <= BF16_L2
