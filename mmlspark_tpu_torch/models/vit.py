"""Vision Transformer family: the port of ``mmlspark_tpu.models.vit``.

The zoo's attention backbone with the JAX package's numbers in the same
places, so a checkpoint of either package gives the same features in both:

- **Patches.** The patch embedding is a ``patch_size``-strided conv
  without padding (flax's NHWC ``VALID`` conv with an HWIO kernel; here
  OIHW), plus its bias; ``patches`` is the ``(gh * gw)`` row-major token
  sequence in f32. A class token (zeros at init) leads the sequence and a
  learned ``pos_embedding`` (``normal(0.02)`` at init, its length set by
  the image size) is added.
- **Blocks** are pre-LN: ``x + MHSA(LN(x))``, then ``x + MLP(LN(x))``
  with erf GELU. The attention's ``qkv`` projection is flax's
  ``DenseGeneral((3, h, d))``: its kernel ``(c, 3, h, d)`` is this
  module's ``qkv.weight`` ``(3 * h * d, c)`` transposed.
- **Rounding points** (``dtype=torch.bfloat16``, the default as in the
  JAX package): every matrix product, conv and bias add rounds to bf16
  (f32 parameters cast per call, as flax casts them); layer norms take
  their statistics in f32 (mean and mean of squares, ``var = max(0, E[x^2]
  - E[x]^2)``, eps 1e-6, flax's defaults) and round once to bf16;
  ``encoder``, ``pool`` and ``logits`` widen to f32.
- **Attention** is ``ops.ring_attention.dense_attention``, or with
  ``seq_group`` (a ``torch.distributed`` group of two ranks or more)
  sequence-parallel :func:`~mmlspark_tpu_torch.ops.ring_attention.ring_attention`:
  every rank runs the whole model on the same batch, the token dimension is
  padded to a multiple of the group's size (197 tokens at 224/16 never
  divide), each rank attends its block of queries with the pad tail in
  ``kv_mask``, and the blocks are all-gathered and the pad sliced off.

``forward(x, until=name)`` stops after the named output, as the zoo's
ResNet does. ``from_flax_variables``/``to_flax_variables`` convert between
flax's ``{"params"}`` tree and this module's state, and
``init_flax_variables`` reproduces flax's seeded init (the JAX package's
``init_vit(seed)``) without JAX, within 4 ulp: the same keys, Threefry
draws, truncated normal (lecun) and normal.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mmlspark_tpu_torch.models import resnet as _R
from mmlspark_tpu_torch.ops.ring_attention import dense_attention, ring_attention

LAYER_NAMES = ("logits", "pool", "encoder", "patches")
LN_EPS = 1e-6  # flax.linen.LayerNorm's default epsilon


class LayerNorm(nn.Module):
    """flax's LayerNorm: f32 statistics, one rounding to ``dtype``."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
        xf = x.float()
        mean = xf.mean(-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(-1, keepdim=True) - mean * mean, min=0.0)
        y = (xf - mean) * (torch.rsqrt(var + LN_EPS) * self.weight) + self.bias
        return y.to(dtype)


def _dense(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """flax Dense in ``x``'s dtype: the product and the bias add each round."""
    return F.linear(x, lin.weight.to(x.dtype)) + lin.bias.to(x.dtype)


class ViTEncoderBlock(nn.Module):
    """One pre-LN transformer block: x + MHSA(LN(x)); x + MLP(LN(x))."""

    def __init__(self, c: int, num_heads: int, mlp_dim: int):
        super().__init__()
        self.num_heads = num_heads
        self.ln_1, self.ln_2 = LayerNorm(c), LayerNorm(c)
        self.qkv = nn.Linear(c, 3 * c)
        self.out = nn.Linear(c, c)
        self.mlp_1 = nn.Linear(c, mlp_dim)
        self.mlp_2 = nn.Linear(mlp_dim, c)

    def forward(self, x: torch.Tensor, attend: Any) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        qkv = _dense(self.ln_1(x, x.dtype), self.qkv).view(b, n, 3, h, c // h)
        o = attend(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]).reshape(b, n, c)
        x = x + _dense(o, self.out)
        y = _dense(self.ln_2(x, x.dtype), self.mlp_1)
        y = F.gelu(y, approximate="none")  # erf GELU, as torchvision's
        return x + _dense(y, self.mlp_2)


class ViT(nn.Module):
    """ViT with named outputs for ``cut_output_layers`` truncation.

    Layer-name order (outermost first) matches the zoo convention:
    ["logits", "pool", "encoder", "patches"]; ``pool`` is the class token
    after the final LayerNorm (the featurization vector), ``encoder`` the
    whole token sequence. ``image_size`` sets the ``pos_embedding`` length
    (flax infers it from the init input)."""

    LAYER_NAMES = LAYER_NAMES

    def __init__(self, patch_size: int = 16, hidden_dim: int = 768, depth: int = 12,
                 num_heads: int = 12, mlp_dim: int = 3072, num_classes: int = 1000,
                 dtype: torch.dtype = torch.bfloat16, image_size: int = 224,
                 seq_group: Any = None):
        super().__init__()
        if hidden_dim % num_heads:
            raise ValueError(f"hidden dim {hidden_dim} not divisible by heads {num_heads}")
        self.patch_size, self.hidden_dim, self.depth = patch_size, hidden_dim, depth
        self.num_heads, self.mlp_dim, self.num_classes = num_heads, mlp_dim, num_classes
        self.dtype, self.seq_group = dtype, seq_group
        n = (image_size // patch_size) ** 2 + 1
        self.conv_proj = nn.Conv2d(3, hidden_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, hidden_dim))
        self.pos_embedding = nn.Parameter(torch.zeros(1, n, hidden_dim))
        self.blocks = nn.ModuleList(
            ViTEncoderBlock(hidden_dim, num_heads, mlp_dim) for _ in range(depth))
        self.ln = LayerNorm(hidden_dim)
        self.head = nn.Linear(hidden_dim, num_classes)

    def output_names(self) -> list:
        """Output names in evaluation order."""
        return list(reversed(LAYER_NAMES))

    def _attend(self) -> Any:
        from mmlspark_tpu_torch.parallel.mesh import group_rank_size

        if self.seq_group is None:
            return dense_attention
        rank, size = group_rank_size(self.seq_group)
        if size <= 1:
            return dense_attention
        group = self.seq_group

        def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
            from mmlspark_tpu_torch.parallel import collectives

            b, n = q.shape[:2]
            n_pad = -(-n // size) * size
            pad = (0, 0, 0, 0, 0, n_pad - n)
            blk = n_pad // size
            sl = slice(rank * blk, (rank + 1) * blk)
            mask = (torch.arange(n_pad, device=q.device) < n).expand(b, n_pad)
            o = ring_attention(F.pad(q, pad)[:, sl], F.pad(k, pad)[:, sl], F.pad(v, pad)[:, sl],
                               group=group, kv_mask=mask[:, sl])
            # every rank's block of queries, in rank order, on every rank
            whole = collectives.all_gather(o.transpose(0, 1).contiguous(), group)
            return whole.transpose(0, 1)[:, :n]

        return attend

    def forward(self, x: torch.Tensor, until: Optional[str] = None) -> dict:
        """x: (N, H, W, 3) -> {name: output} up to and including ``until``."""
        if until is not None and until not in LAYER_NAMES:
            raise ValueError(f"unknown output {until!r}; known: {list(LAYER_NAMES)}")
        outputs: dict = {}
        dt = self.dtype
        x = x.to(dt).permute(0, 3, 1, 2)
        p = F.conv2d(x, self.conv_proj.weight.to(dt), stride=self.patch_size)
        p = p + self.conv_proj.bias.to(dt)[None, :, None, None]
        b, c = p.shape[:2]
        seq = p.flatten(2).transpose(1, 2)                    # (B, gh * gw, C)
        outputs["patches"] = seq.float()
        if until == "patches":
            return outputs
        seq = torch.cat([self.cls_token.to(dt).expand(b, 1, c), seq], dim=1)
        if seq.shape[1] != self.pos_embedding.shape[1]:
            raise ValueError(f"{seq.shape[1]} tokens but pos_embedding holds "
                             f"{self.pos_embedding.shape[1]}: build the ViT at this image size")
        seq = seq + self.pos_embedding.to(dt)
        attend = self._attend()
        for blk in self.blocks:
            seq = blk(seq, attend)
        seq = self.ln(seq, dt)
        outputs["encoder"] = seq.float()
        if until == "encoder":
            return outputs
        pooled = seq[:, 0]
        outputs["pool"] = pooled.float()
        if until == "pool":
            return outputs
        outputs["logits"] = _dense(pooled, self.head).float()
        return outputs


def vit_b16(**kw: Any) -> ViT:
    return ViT(**kw)


def vit_tiny(**kw: Any) -> ViT:
    """Test-scale ViT (the ResNet8 of ViTs)."""
    kw.setdefault("patch_size", 4)
    kw.setdefault("hidden_dim", 32)
    kw.setdefault("depth", 2)
    kw.setdefault("num_heads", 2)
    kw.setdefault("mlp_dim", 64)
    kw.setdefault("image_size", 32)
    return ViT(**kw)


VITS: dict = {"ViTB16": vit_b16, "ViTTiny": vit_tiny}


# -- flax layout -------------------------------------------------------------


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def _a(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy().copy()


def _flax_dense(lin: nn.Linear) -> dict:
    return {"bias": _a(lin.bias), "kernel": _a(lin.weight.T)}


def _flax_ln(ln: LayerNorm) -> dict:
    return {"bias": _a(ln.bias), "scale": _a(ln.weight)}


def to_flax_variables(module: ViT) -> dict:
    """This module's weights as flax's ``{"params"}`` tree of f32 numpy
    arrays (the inverse of :func:`from_flax_variables`)."""
    c, h = module.hidden_dim, module.num_heads
    params: dict = {}
    for i, blk in enumerate(module.blocks):
        params[f"block_{i}"] = {
            "ln_1": _flax_ln(blk.ln_1), "ln_2": _flax_ln(blk.ln_2),
            "mlp_1": _flax_dense(blk.mlp_1), "mlp_2": _flax_dense(blk.mlp_2),
            "out": _flax_dense(blk.out),
            "qkv": {"bias": _a(blk.qkv.bias).reshape(3, h, c // h),
                    "kernel": _a(blk.qkv.weight.T).reshape(c, 3, h, c // h)},
        }
    params["cls_token"] = _a(module.cls_token)
    params["conv_proj"] = {"bias": _a(module.conv_proj.bias),
                           "kernel": _a(module.conv_proj.weight.permute(2, 3, 1, 0))}
    params["head"] = _flax_dense(module.head)
    params["ln"] = _flax_ln(module.ln)
    params["pos_embedding"] = _a(module.pos_embedding)
    return {"params": params}


def from_flax_variables(module: ViT, variables: dict) -> dict:
    """flax ``{"params"}`` numpy tree -> this module's ``state_dict``.
    Strict: a missing entry raises ``KeyError``, and so does one left over."""
    p = dict(variables["params"])
    state: dict = {}
    used: set = set()

    def take(*path: str) -> np.ndarray:
        node = p
        for k in path:
            node = node[k]
        used.add(path)
        return np.asarray(node, np.float32)

    def dense(prefix: str, *path: str) -> None:
        state[f"{prefix}.weight"] = _t(take(*path, "kernel")).T.contiguous()
        state[f"{prefix}.bias"] = _t(take(*path, "bias"))

    def ln(prefix: str, *path: str) -> None:
        state[f"{prefix}.weight"] = _t(take(*path, "scale"))
        state[f"{prefix}.bias"] = _t(take(*path, "bias"))

    c = module.hidden_dim
    state["conv_proj.weight"] = _t(take("conv_proj", "kernel")).permute(3, 2, 0, 1).contiguous()
    state["conv_proj.bias"] = _t(take("conv_proj", "bias"))
    state["cls_token"] = _t(take("cls_token"))
    state["pos_embedding"] = _t(take("pos_embedding"))
    for i in range(module.depth):
        b, t = f"blocks.{i}", f"block_{i}"
        ln(f"{b}.ln_1", t, "ln_1")
        ln(f"{b}.ln_2", t, "ln_2")
        state[f"{b}.qkv.weight"] = _t(take(t, "qkv", "kernel").reshape(c, -1)).T.contiguous()
        state[f"{b}.qkv.bias"] = _t(take(t, "qkv", "bias").reshape(-1))
        for name in ("out", "mlp_1", "mlp_2"):
            dense(f"{b}.{name}", t, name)
    ln("ln", "ln")
    dense("head", "head")

    def leaves(tree: Any, path: tuple = ()) -> list:
        if not isinstance(tree, dict):
            return [path]
        return [q for k, v in tree.items() for q in leaves(v, path + (k,))]

    extra = [q for q in leaves(p) if q not in used]
    if extra:
        raise KeyError(f"flax variables hold entries the module lacks: {extra[:8]}")
    return state


def load_flax_variables(module: ViT, variables: dict) -> ViT:
    module.load_state_dict(from_flax_variables(module, variables), strict=True)
    return module


def init_flax_variables(module: ViT, seed: int = 0, device: Any = "cpu") -> dict:
    """flax's seeded init of ``module`` (``model.init(PRNGKey(seed))`` of the
    JAX package's ViT), in flax layout, loaded into ``module`` too: every
    kernel is ``lecun_normal`` under its module path's key (the scope's
    first parameter; ``qkv`` over its flattened ``(c, 3 * h * d)`` shape),
    ``pos_embedding`` ``normal(0.02)`` as the root scope's second
    parameter; biases, ``cls_token`` 0, LayerNorm scales 1. Within 4 ulp of
    flax's numbers (XLA's f32 ``log1p`` rounds differently); ``device`` is
    where the draws are computed."""
    c, h, mlp = module.hidden_dim, module.num_heads, module.mlp_dim
    ps = module.patch_size

    def lecun(path: tuple, shape: tuple, fan_in: int) -> torch.Tensor:
        return _R.lecun_normal(_R._flax_key(seed, path), shape, fan_in, device)

    with torch.no_grad():
        for prm in module.parameters():
            prm.zero_()
        module.conv_proj.weight.copy_(
            lecun(("conv_proj",), (ps, ps, 3, c), ps * ps * 3).permute(3, 2, 0, 1))
        module.pos_embedding.copy_(
            _R.normal(_R._flax_key(seed, (), 2), tuple(module.pos_embedding.shape), 0.02, device))
        for i, blk in enumerate(module.blocks):
            t = f"block_{i}"
            for ln in (blk.ln_1, blk.ln_2):
                ln.weight.fill_(1.0)
            blk.qkv.weight.copy_(lecun((t, "qkv"), (c, 3 * c), c).T)
            blk.out.weight.copy_(lecun((t, "out"), (c, c), c).T)
            blk.mlp_1.weight.copy_(lecun((t, "mlp_1"), (c, mlp), c).T)
            blk.mlp_2.weight.copy_(lecun((t, "mlp_2"), (mlp, c), mlp).T)
        module.ln.weight.fill_(1.0)
        module.head.weight.copy_(lecun(("head",), (c, module.num_classes), c).T)
    return to_flax_variables(module)
