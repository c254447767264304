"""ResNet family as PyTorch modules: the port of ``mmlspark_tpu.models.resnet``.

The JAX package's backbone is a flax module; this is the same network with
the same numbers in the same places, so a checkpoint of either package
gives the same features in both:

- **Padding.** flax's ``"SAME"`` is asymmetric at stride 2: a 3x3 conv pads
  (0, 1) on an even input, the 7x7 stem (2, 3) at 224, and the SAME 3x3 max
  pool pads with -inf the same way. Convs here take no padding argument in
  those cases: the pads are computed from the input's size and applied with
  ``F.pad`` (-inf for the pool). With ``torch_padding=True`` strided convs
  and the pool pad symmetrically, as torchvision's, so imported
  torchvision weights reproduce torchvision's features.
- **Rounding points** (``dtype=torch.bfloat16``, the default as in the JAX
  package): the input is cast to bf16; each conv rounds its output to bf16
  (f32 kernel cast to bf16, f32 accumulation); each batch norm computes in
  f32 from the bf16 map and f32 statistics and rounds once to bf16, as
  flax's ``_normalize`` promotes to f32; the global mean accumulates in f32
  and rounds to bf16, then widens for ``pool``; the head's product and its
  bias add each round to bf16, and ``logits`` widen to f32.
- **Layout.** Activations are NCHW tensors in ``channels_last`` memory,
  so the named maps ``stem`` and ``layer1``... come back as ``(N, H, W, C)``
  views without a copy, the JAX package's layout; ``pool`` and ``logits``
  are f32 ``(N, C)``.

``forward(x, until=name)`` stops after the named output, so a featurizer cut
at ``pool`` never runs the head. Parameters stay f32 (cast per call, as
flax casts them); ``from_flax_variables``/``to_flax_variables`` convert
between flax's ``{"params", "batch_stats"}`` tree (HWIO conv kernels,
(in, out) dense kernels, flax's module names) and this module's state.
``init_flax_variables`` reproduces flax's seeded init (the JAX package's
``init_resnet(seed)``): the same keys, Threefry draws and truncated normal,
within 2 ulp.
"""

from __future__ import annotations

import hashlib
from typing import Any, Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from mmlspark_tpu_torch.models.gbdt import sampling

LAYER_NAMES = ("logits", "pool", "layer4", "layer3", "layer2", "layer1", "stem")
BN_EPS = 1e-5  # flax.linen.BatchNorm's default epsilon


def _same_pads(n: int, k: int, s: int) -> tuple:
    """XLA's "SAME" padding of one spatial dim: (low, high)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pads(x: torch.Tensor, k: int, s: int, torch_padding: bool) -> tuple:
    """(left, right, top, bottom) pads for a k x k window at stride s."""
    if torch_padding and s > 1:
        p = (k - 1) // 2
        return p, p, p, p
    (t, b), (lft, r) = _same_pads(x.shape[2], k, s), _same_pads(x.shape[3], k, s)
    return lft, r, t, b


class Conv(nn.Module):
    """Bias-free k x k conv; weight OIHW (flax: HWIO ``kernel``)."""

    def __init__(self, cin: int, cout: int, k: int, stride: int = 1,
                 torch_padding: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, k, k))
        self.k, self.stride, self.torch_padding = k, stride, torch_padding

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight.to(dtype=x.dtype, memory_format=torch.channels_last)
        lft, r, t, b = _pads(x, self.k, self.stride, self.torch_padding)
        if lft == r and t == b:
            return F.conv2d(x, w, stride=self.stride, padding=(t, lft))
        return F.conv2d(F.pad(x, (lft, r, t, b)), w, stride=self.stride)


class BatchNorm(nn.Module):
    """Inference batch norm: f32 scale/bias/statistics, computed in f32 and
    rounded once to the input's dtype (flax promotes to f32 the same way)."""

    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                            training=False, momentum=0.0, eps=BN_EPS)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, cin: int, filters: int, stride: int = 1, torch_padding: bool = False):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv(cin, filters, 3, stride, torch_padding), Conv(filters, filters, 3)])
        self.bns = nn.ModuleList([BatchNorm(filters), BatchNorm(filters)])
        self.proj = self.proj_bn = None
        if stride != 1 or cin != filters:
            self.proj = Conv(cin, filters, 1, stride)
            self.proj_bn = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu_(self.bns[0](self.convs[0](x)))
        y = self.bns[1](self.convs[1](y))
        res = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu_(y.add_(res))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, cin: int, filters: int, stride: int = 1, torch_padding: bool = False):
        super().__init__()
        self.convs = nn.ModuleList([
            Conv(cin, filters, 1), Conv(filters, filters, 3, stride, torch_padding),
            Conv(filters, filters * 4, 1)])
        self.bns = nn.ModuleList([BatchNorm(filters), BatchNorm(filters), BatchNorm(filters * 4)])
        self.proj = self.proj_bn = None
        if stride != 1 or cin != filters * 4:
            self.proj = Conv(cin, filters * 4, 1, stride)
            self.proj_bn = BatchNorm(filters * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu_(self.bns[0](self.convs[0](x)))
        y = F.relu_(self.bns[1](self.convs[1](y)))
        y = self.bns[2](self.convs[2](y))
        res = x if self.proj is None else self.proj_bn(self.proj(x))
        return F.relu_(y.add_(res))


class ResNet(nn.Module):
    """ResNet with named stage outputs (see the module docstring).

    Layer-name order (outermost first) mirrors the reference's model schema
    ``layerNames`` ordering used by ``cutOutputLayers``."""

    LAYER_NAMES = LAYER_NAMES

    def __init__(self, stage_sizes: Sequence[int], block: type = BottleneckBlock,
                 num_classes: int = 1000, num_filters: int = 64,
                 dtype: torch.dtype = torch.bfloat16, small_inputs: bool = False,
                 torch_padding: bool = False):
        super().__init__()
        self.stage_sizes, self.dtype = list(stage_sizes), dtype
        self.small_inputs, self.torch_padding = small_inputs, torch_padding
        if small_inputs:  # CIFAR-style stem: 3x3, stride 1, no max pool
            self.conv_init = Conv(3, num_filters, 3)
        else:
            self.conv_init = Conv(3, num_filters, 7, 2, torch_padding)
        self.bn_init = BatchNorm(num_filters)
        blocks, cin = [], num_filters
        for i, count in enumerate(stage_sizes):
            for j in range(count):
                filters = num_filters * 2 ** i
                blocks.append(block(cin, filters, 2 if i > 0 and j == 0 else 1, torch_padding))
                cin = filters * block.expansion
        self.blocks = nn.ModuleList(blocks)
        self.head = nn.Linear(cin, num_classes)
        nn.init.zeros_(self.head.weight)
        nn.init.zeros_(self.head.bias)

    def output_names(self) -> list:
        """Output names in evaluation order: stem, layer1..., pool, logits."""
        return ["stem"] + [f"layer{i + 1}" for i in range(len(self.stage_sizes))] + [
            "pool", "logits"]

    def forward(self, x: torch.Tensor, until: Optional[str] = None) -> dict:
        """x: (N, H, W, 3) -> {name: output} up to and including ``until``."""
        names = self.output_names()
        if until is not None and until not in names:
            raise ValueError(f"unknown output {until!r}; known: {names}")
        outputs: dict = {}

        def emit(name: str, value: torch.Tensor) -> bool:
            outputs[name] = value
            return name == until

        x = x.to(self.dtype).permute(0, 3, 1, 2).contiguous(memory_format=torch.channels_last)
        x = F.relu_(self.bn_init(self.conv_init(x)))
        if not self.small_inputs:
            lft, r, t, b = _pads(x, 3, 2, self.torch_padding)
            x = F.max_pool2d(F.pad(x, (lft, r, t, b), value=float("-inf")), 3, 2)
        if emit("stem", x.permute(0, 2, 3, 1)):
            return outputs
        k = 0
        for i, count in enumerate(self.stage_sizes):
            for _ in range(count):
                x = self.blocks[k](x)
                k += 1
            if emit(f"layer{i + 1}", x.permute(0, 2, 3, 1)):
                return outputs
        pooled = torch.mean(x, dim=(2, 3), dtype=torch.float32).to(self.dtype)
        if emit("pool", pooled.float()):
            return outputs
        y = F.linear(pooled, self.head.weight.to(self.dtype)) + self.head.bias.to(self.dtype)
        emit("logits", y.float())
        return outputs


def resnet8(**kw: Any) -> ResNet:
    """Three-stage compact ResNet (the trained ``ResNet8_Digits`` zoo entry)."""
    kw.setdefault("num_filters", 16)
    return ResNet(stage_sizes=[1, 1, 1], block=BasicBlock, **kw)


def resnet18(**kw: Any) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], block=BasicBlock, **kw)


def resnet34(**kw: Any) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block=BasicBlock, **kw)


def resnet50(**kw: Any) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], block=BottleneckBlock, **kw)


def resnet101(**kw: Any) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 23, 3], block=BottleneckBlock, **kw)


RESNETS: dict = {
    "ResNet8": resnet8,
    "ResNet18": resnet18,
    "ResNet34": resnet34,
    "ResNet50": resnet50,
    "ResNet101": resnet101,
}


# -- flax layout -------------------------------------------------------------


def _flax_modules(module: ResNet) -> list:
    """(flax path, torch module, kind) for every conv, batch norm and the
    head, in flax's names: conv_init, bn_init, <Block>_k/{Conv_i,
    BatchNorm_i, proj, proj_bn}, head."""
    out = [(("conv_init",), module.conv_init, "conv"), (("bn_init",), module.bn_init, "bn")]
    for k, blk in enumerate(module.blocks):
        name = f"{type(blk).__name__}_{k}"
        for i, (c, b) in enumerate(zip(blk.convs, blk.bns)):
            out += [((name, f"Conv_{i}"), c, "conv"), ((name, f"BatchNorm_{i}"), b, "bn")]
        if blk.proj is not None:
            out += [((name, "proj"), blk.proj, "conv"), ((name, "proj_bn"), blk.proj_bn, "bn")]
    out.append((("head",), module.head, "dense"))
    return out


def _get(tree: dict, path: tuple) -> dict:
    for p in path:
        tree = tree[p]
    return tree


def _put(tree: dict, path: tuple, value: dict) -> None:
    for p in path[:-1]:
        tree = tree.setdefault(p, {})
    tree[path[-1]] = value


def _t(a: Any) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32))


def from_flax_variables(module: ResNet, variables: dict) -> dict:
    """flax ``{"params", "batch_stats"}`` numpy tree -> this module's
    ``state_dict`` (HWIO -> OIHW, dense (in, out) -> (out, in)). Strict: a
    missing entry raises ``KeyError``, and so does an entry that is left
    over."""
    params, stats = variables["params"], variables.get("batch_stats", {})
    state: dict = {}
    used = set()
    prefix = {id(m): n for n, m in module.named_modules()}
    for path, m, kind in _flax_modules(module):
        p = prefix[id(m)]
        used.add(path)
        if kind == "conv":
            state[f"{p}.weight"] = _t(_get(params, path)["kernel"]).permute(3, 2, 0, 1).contiguous()
        elif kind == "dense":
            d = _get(params, path)
            state[f"{p}.weight"] = _t(d["kernel"]).T.contiguous()
            state[f"{p}.bias"] = _t(d["bias"])
        else:
            d, s = _get(params, path), _get(stats, path)
            state[f"{p}.weight"], state[f"{p}.bias"] = _t(d["scale"]), _t(d["bias"])
            state[f"{p}.running_mean"], state[f"{p}.running_var"] = _t(s["mean"]), _t(s["var"])

    def leaves(tree: dict, path: tuple = ()) -> list:
        if any(not isinstance(v, dict) for v in tree.values()):
            return [path]
        return [q for k, v in tree.items() for q in leaves(v, path + (k,))]

    extra = [p for p in leaves(params) + leaves(stats) if p not in used]
    if extra:
        raise KeyError(f"flax variables hold entries the module lacks: {extra[:8]}")
    return state


def to_flax_variables(module: ResNet) -> dict:
    """This module's weights as flax's ``{"params", "batch_stats"}`` tree of
    f32 numpy arrays (the inverse of ``from_flax_variables``)."""
    params: dict = {}
    stats: dict = {}

    def a(t: torch.Tensor) -> np.ndarray:
        return t.detach().float().cpu().numpy()

    for path, m, kind in _flax_modules(module):
        if kind == "conv":
            _put(params, path, {"kernel": a(m.weight.permute(2, 3, 1, 0)).copy()})
        elif kind == "dense":
            _put(params, path, {"bias": a(m.bias), "kernel": a(m.weight.T).copy()})
        else:
            _put(params, path, {"bias": a(m.bias), "scale": a(m.weight)})
            _put(stats, path, {"mean": a(m.running_mean), "var": a(m.running_var)})
    return {"batch_stats": stats, "params": params}


def load_flax_variables(module: ResNet, variables: dict) -> ResNet:
    module.load_state_dict(from_flax_variables(module, variables), strict=True)
    return module


# jax.random.truncated_normal(-2, 2) draws uniform(erf(-2/sqrt2), erf(2/sqrt2)):
# the bounds as XLA rounds them in f32 (-0.9544997)
_ERF_SQRT2 = 0.95449972152709961
# XLA's f32 erf_inv (Giles' single-precision approximation): coefficients
# for w = -log1p(-x^2) < 5 and >= 5, highest power first
_ERFINV_SMALL = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_LARGE = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to f32, as XLA's CPU backend fuses it: the
    f32 product is exact in f64, and the f64 sum rounds to the f32 result."""
    return (a.double() * b.double() + c.double()).float()


def _erfinv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's f32 ``erf_inv`` with fused Horner steps. ``log1p`` is taken in
    f64 and rounded once to f32, so the card and the CPU agree; XLA's own
    f32 ``log1p`` rounds differently in ~9% of inputs, so results differ
    from ``jax.lax.erf_inv`` by at most 2 ulp (equal in ~99%)."""
    w = -torch.log1p((-x * x).double()).float()
    small = w < 5.0
    w = torch.where(small, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i: int) -> torch.Tensor:
        return torch.where(small, _ERFINV_SMALL[i], _ERFINV_LARGE[i])

    p = coef(0).expand_as(x)
    for i in range(1, len(_ERFINV_SMALL)):
        p = _fma32(p, w, coef(i))
    return torch.where(x.abs() == 1.0, x * torch.finfo(torch.float32).max, p * x)


def _flax_key(seed: int, path: tuple, counter: int = 1) -> tuple:
    """The key flax's ``make_rng("params")`` gives the ``counter``-th
    parameter of the module at ``path`` (flax.core.scope ``LazyRng`` /
    ``_fold_in_static``): the first 4 bytes of a SHA-1 of the path's names
    and the counter (big-endian), folded into ``PRNGKey(seed)``."""
    m = hashlib.sha1()
    for part in (*path, counter):
        m.update(part.encode() if isinstance(part, str)
                 else part.to_bytes((part.bit_length() + 7) // 8, "big"))
    return sampling.fold_in((0, int(seed) & 0xFFFFFFFF), int.from_bytes(m.digest()[:4], "big"))


def lecun_normal(key: tuple, shape: tuple, fan_in: int,
                 device: "str | torch.device" = "cpu") -> torch.Tensor:
    """``flax.linen.initializers.lecun_normal()(key, shape)`` in f32: a
    truncated normal in (-2, 2) (``jax.random.truncated_normal``: the
    Threefry uniform in (erf(-sqrt2), erf(sqrt2)) with its fused scale and
    shift, sqrt(2) * erf_inv, clipped to the open interval) times
    sqrt(1/fan_in) / 0.87962566103423978, every step rounded to f32 as
    XLA does."""
    n = int(np.prod(shape))
    lo = torch.tensor(-_ERF_SQRT2, dtype=torch.float32, device=device)
    hi = torch.tensor(_ERF_SQRT2, dtype=torch.float32, device=device)
    unit = sampling.bits_to_unit(sampling.random_bits(key, n, device))
    u = torch.maximum(lo, _fma32(unit, hi - lo, lo))
    out = torch.tensor(np.sqrt(2), dtype=torch.float32, device=device) * _erfinv32(u)
    bound = float(np.nextafter(np.float32(2.0), np.float32(0.0)))
    out = out.clamp(-bound, bound)
    std = np.float32(np.sqrt(np.float32(1.0 / fan_in))) / np.float32(0.87962566103423978)
    return (out * torch.tensor(std, device=device)).reshape(shape)


def init_flax_variables(module: ResNet, seed: int = 0,
                        device: "str | torch.device" = "cpu") -> dict:
    """flax's seeded init of ``module`` (``model.init(PRNGKey(seed))`` of
    the JAX package's ResNet), in flax layout: every conv and dense kernel
    is ``lecun_normal`` under its module path's key (:func:`_flax_key`:
    each kernel is its scope's first parameter); biases and batch-norm
    shifts 0; batch-norm scales 1, the last of each block 0; statistics
    mean 0, var 1. Equal to flax's numbers within 4 ulp, 99% of them
    bitwise (XLA's f32 ``log1p`` rounds differently); ``device`` is where
    the draws are computed."""
    with torch.no_grad():
        for path, m, kind in _flax_modules(module):
            if kind == "bn":
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                continue
            w = m.weight
            if kind == "dense":   # (out, in) here, (in, out) in flax
                shape, fan_in = (w.shape[1], w.shape[0]), w.shape[1]
                m.weight.copy_(lecun_normal(_flax_key(seed, path), shape, fan_in, device).T)
                m.bias.zero_()
            else:                 # OIHW here, HWIO in flax
                o, i, kh, kw = w.shape
                k = lecun_normal(_flax_key(seed, path), (kh, kw, i, o), kh * kw * i, device)
                m.weight.copy_(k.permute(3, 2, 0, 1))
        for blk in module.blocks:
            blk.bns[-1].weight.zero_()
    return to_flax_variables(module)
