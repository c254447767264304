"""Model zoo — the ModelDownloader analogue; the port of
``mmlspark_tpu.downloader.zoo``.

The on-disk layout is the JAX package's: a repository directory of
``<name>.schema.json`` plus ``<name>.msgpack``, flax-layout weights in
flax's msgpack bytes, sha256-checked, so a model either package installed
loads in the other. The port reads and writes those bytes with its own
``flax_msgpack`` (no flax, no msgpack). The trained checkpoints ship inside
the port too (``downloader/builtin/``, byte-for-byte copies of the JAX
package's). Checkpoints stored float16 are widened to float32 on load.

A schema with no checkpoint (``ResNet50`` and the other large variants)
gets a seeded random init with a loud warning, as in the JAX package:
flax's own init of ``PRNGKey(schema.seed)`` reproduced without JAX
(``models.resnet.init_flax_variables``, within 4 ulp), so both packages'
seeded ResNet-50s give the same features. ViT schemas raise
``NotImplementedError`` until the port has a ViT (ROADMAP Queue A item 9).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
from dataclasses import asdict, dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from mmlspark_tpu_torch.core.device import resolve_device
from mmlspark_tpu_torch.core.utils import retry_with_backoff
from mmlspark_tpu_torch.downloader import flax_msgpack
from mmlspark_tpu_torch.downloader.torch_import import VIT_TODO

log = logging.getLogger("mmlspark_tpu_torch.downloader")

# the JAX package's repository: a model either package installs is found
# by the other
DEFAULT_REPO = os.path.join(
    os.environ.get("MMLSPARK_TPU_HOME", os.path.expanduser("~/.mmlspark_tpu")), "models"
)

# trained checkpoints shipped inside the package (copies of the JAX
# package's tools/train_zoo_backbone.py outputs)
PACKAGED_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "builtin")


@dataclass
class ModelSchema:
    """Metadata for one zoo model (downloader/Schema.scala:54-66 analogue)."""

    name: str
    variant: str = "ResNet50"
    num_classes: int = 1000
    image_size: int = 224
    small_inputs: bool = False
    input_node: str = "image"
    layer_names: list = field(
        default_factory=lambda: [
            "logits", "pool", "layer4", "layer3", "layer2", "layer1", "stem",
        ]
    )
    uri: Optional[str] = None
    sha256: Optional[str] = None
    seed: int = 0
    # torch-exact strided padding: set for torchvision-imported weights
    torch_padding: bool = False
    # backbone width (ResNet num_filters); None = the variant's default
    num_filters: Optional[int] = None

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)


_VIT_LAYERS = ("logits", "pool", "encoder", "patches")

BUILTIN_MODELS = {
    "ResNet18": ModelSchema(name="ResNet18", variant="ResNet18"),
    "ResNet34": ModelSchema(name="ResNet34", variant="ResNet34"),
    "ResNet50": ModelSchema(name="ResNet50", variant="ResNet50"),
    "ResNet101": ModelSchema(name="ResNet101", variant="ResNet101"),
    "ResNet50_ImageNet_CIFAR": ModelSchema(
        name="ResNet50_ImageNet_CIFAR",
        variant="ResNet50",
        num_classes=10,
        image_size=32,
        small_inputs=True,
    ),
    "ViTB16": ModelSchema(
        name="ViTB16",
        variant="ViTB16",
        layer_names=list(_VIT_LAYERS),
    ),
    "ViTTiny": ModelSchema(
        name="ViTTiny",
        variant="ViTTiny",
        num_classes=10,
        image_size=32,
        layer_names=list(_VIT_LAYERS),
    ),
}


def build_module(schema: ModelSchema) -> Any:
    """The schema's backbone (bf16, as the JAX package's), uninitialised;
    ResNets only."""
    from mmlspark_tpu_torch.models.resnet import RESNETS

    if schema.variant.startswith("ViT"):
        raise NotImplementedError(VIT_TODO)
    if schema.variant not in RESNETS:
        raise ValueError(f"unknown variant {schema.variant!r}; known: {list(RESNETS)}")
    width = {} if schema.num_filters is None else {"num_filters": schema.num_filters}
    return RESNETS[schema.variant](
        num_classes=schema.num_classes, small_inputs=schema.small_inputs,
        torch_padding=schema.torch_padding, **width,
    )


class ModelDownloader:
    """Local/remote model repository client."""

    def __init__(self, repo_dir: str = DEFAULT_REPO):
        self.repo_dir = repo_dir
        os.makedirs(repo_dir, exist_ok=True)

    def list_models(self) -> list:
        names = set(BUILTIN_MODELS)
        dirs = [self.repo_dir]
        if os.path.isdir(PACKAGED_DIR):
            dirs.append(PACKAGED_DIR)
        for d in dirs:
            for f in os.listdir(d):
                if f.endswith(".schema.json"):
                    names.add(f[: -len(".schema.json")])
        return sorted(names)

    def _paths(self, name: str) -> tuple:
        return (
            os.path.join(self.repo_dir, f"{name}.schema.json"),
            os.path.join(self.repo_dir, f"{name}.msgpack"),
        )

    def install_blob(self, schema: ModelSchema, blob: bytes) -> ModelSchema:
        """Write a serialized-weights blob + schema into the repo (single
        place that knows the on-disk layout); fills sha256 if absent."""
        if not schema.sha256:
            schema.sha256 = hashlib.sha256(blob).hexdigest()
        spath, wpath = self._paths(schema.name)
        with open(wpath, "wb") as f:
            f.write(blob)
        with open(spath, "w") as f:
            f.write(schema.to_json())
        return schema

    def register(self, schema: ModelSchema, variables: Any) -> None:
        """Install a model (e.g. converted pretrained weights) into the repo."""
        blob = flax_msgpack.msgpack_serialize(_to_np(variables))
        schema.sha256 = hashlib.sha256(blob).hexdigest()
        self.install_blob(schema, blob)

    def download_by_name(self, name: str) -> ModelSchema:
        """Ensure the named model exists locally; return its schema."""
        spath, wpath = self._paths(name)
        pk_s = os.path.join(PACKAGED_DIR, f"{name}.schema.json")
        pk_w = os.path.join(PACKAGED_DIR, f"{name}.msgpack")
        packaged = os.path.exists(pk_s) and os.path.exists(pk_w)
        if os.path.exists(spath) and os.path.exists(wpath):
            with open(spath) as f:
                local = ModelSchema(**json.load(f))
            if packaged:
                # a retrained packaged checkpoint supersedes a stale local
                # install (compare by recorded sha256)
                with open(pk_s) as f:
                    pk_schema = ModelSchema(**json.load(f))
                if pk_schema.sha256 and pk_schema.sha256 != local.sha256:
                    log.info("reinstalling %s from updated packaged weights", name)
                else:
                    return local
            else:
                return local
        if packaged:
            # packaged trained checkpoint: install into the local repo verbatim
            with open(pk_s) as f:
                schema = ModelSchema(**json.load(f))
            with open(pk_w, "rb") as f:
                blob = f.read()
            if schema.sha256 and hashlib.sha256(blob).hexdigest() != schema.sha256:
                raise IOError(f"packaged checksum mismatch for model {name}")
            return self.install_blob(schema, blob)
        schema = BUILTIN_MODELS.get(name)
        if schema is None:
            raise KeyError(f"unknown model {name!r}; known: {self.list_models()}")
        schema = ModelSchema(**asdict(schema))  # the table stays unfilled
        if schema.variant.startswith("ViT"):
            raise NotImplementedError(VIT_TODO)
        if schema.uri:  # remote fetch path (with retries); unused offline
            retry_with_backoff(lambda: self._fetch(schema, wpath))
            with open(wpath, "rb") as f:
                blob = f.read()
            schema.sha256 = hashlib.sha256(blob).hexdigest()
            self.install_blob(schema, blob)
        else:
            from mmlspark_tpu_torch.models.resnet import init_flax_variables

            log.warning(
                "model %r has no trained checkpoint in this egress-free "
                "repository; materializing a SEEDED RANDOM init — features "
                "will carry no semantic content (use ResNet8_Digits for "
                "trained weights, or RemoteRepository.sync to import real "
                "checkpoints)",
                name,
            )
            self.register(schema, init_flax_variables(build_module(schema), seed=schema.seed))
        return schema

    def load_variables(self, name: str) -> tuple:
        """Return (flax-layout numpy variables, schema), f16 widened to f32."""
        schema = self.download_by_name(name)
        _, wpath = self._paths(name)
        with open(wpath, "rb") as f:
            blob = f.read()
        if schema.sha256 and hashlib.sha256(blob).hexdigest() != schema.sha256:
            raise IOError(f"checksum mismatch for model {name}")
        return _widen_f16(flax_msgpack.msgpack_restore(blob)), schema

    def load(self, name: str, device: "str | torch.device | None" = None) -> tuple:
        """Return (module on ``device``, variables, schema), ready for
        TorchModel. ``device`` None is the card (raises without one)."""
        from mmlspark_tpu_torch.models.resnet import load_flax_variables

        dev = resolve_device(device)
        variables, schema = self.load_variables(name)
        module = load_flax_variables(build_module(schema), variables)
        return module.to(dev).eval(), variables, schema

    def _fetch(self, schema: ModelSchema, wpath: str) -> None:
        import urllib.request

        urllib.request.urlretrieve(schema.uri, wpath)  # noqa: S310


class RemoteRepository:
    """HTTP model repository (the remote ``Repository[ModelSchema]`` of
    ModelDownloader.scala:55-118): a base URL serving ``index.json`` (list
    of schema dicts) and one ``<name>.msgpack`` weight blob per model.
    ``sync`` mirrors models into a local ModelDownloader repo, verifying
    checksums, with retry/backoff (FaultToleranceUtils analogue)."""

    _NAME_OK = re.compile(r"[A-Za-z0-9._-]+")

    def __init__(
        self,
        base_url: str,
        local: Optional[ModelDownloader] = None,
        timeout_s: float = 60.0,
    ):
        self.base_url = base_url.rstrip("/")
        self.local = local or ModelDownloader()
        self.timeout_s = timeout_s

    def _get(self, path: str) -> bytes:
        import urllib.error
        import urllib.request

        def pull() -> bytes:
            # explicit timeout: a stalled server must raise into the backoff
            # schedule, not hang sync() (retryWithTimeout semantics)
            with urllib.request.urlopen(  # noqa: S310
                f"{self.base_url}/{path}", timeout=self.timeout_s
            ) as r:
                return r.read()

        def retryable(e: Exception) -> bool:
            # 4xx can never succeed on retry; everything else (5xx, network)
            # gets the backoff schedule
            return not (
                isinstance(e, urllib.error.HTTPError) and 400 <= e.code < 500
            )

        return retry_with_backoff(pull, retryable=retryable)

    def list_models(self) -> list:
        index = json.loads(self._get("index.json"))
        return [ModelSchema(**s) for s in index]

    def _checked_name(self, name: str) -> str:
        # remote-controlled names become local file paths: allow only plain
        # identifiers so a hostile index cannot traverse out of repo_dir
        if not self._NAME_OK.fullmatch(name) or ".." in name:
            raise ValueError(f"illegal remote model name {name!r}")
        return name

    def download(self, schema: ModelSchema) -> ModelSchema:
        """Fetch one model's weights into the local repo."""
        name = self._checked_name(schema.name)
        blob = self._get(f"{name}.msgpack")
        if schema.sha256 and hashlib.sha256(blob).hexdigest() != schema.sha256:
            raise IOError(f"checksum mismatch downloading {name}")
        return self.local.install_blob(schema, blob)

    def download_by_name(self, name: str) -> ModelSchema:
        """Fetch schema + weights into the local repo; returns the schema."""
        schema = next((s for s in self.list_models() if s.name == name), None)
        if schema is None:
            raise KeyError(f"model {name!r} not in remote index")
        return self.download(schema)

    def sync(self) -> list:
        """Mirror every remote model locally; returns the schemas.
        The index is fetched once (not per model)."""
        return [self.download(s) for s in self.list_models()]


def _to_np(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_np(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _widen_f16(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _widen_f16(v) for k, v in tree.items()}
    return tree.astype(np.float32) if getattr(tree, "dtype", None) == np.float16 else tree
