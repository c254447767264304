"""The zoo's seeded ViT-B/16 (86M values, 224 x 224) within 4 ulp of
flax's ``init_vit``, and the per-leaf sums of flax's init that
``chip_smoke.py`` holds the card's draw against.

Split from ``tests/test_torch_port_vit.py`` (its ulp check), so the test
workers can share the two out.
"""

from __future__ import annotations

import json
import os

import jax
import numpy as np

from mmlspark_tpu.models.vit import init_vit
from mmlspark_tpu_torch.downloader import zoo
from mmlspark_tpu_torch.models import vit as V

from test_torch_port_vit import _ulp_check


def test_seeded_vit_b16_init_equals_flax_at_full_width():
    """ViT-B/16 at 224 (86M values), the zoo's seeded ViTB16; and the
    per-leaf sums of flax's init that ``chip_smoke.py`` holds the card's
    draw against (``tests/resources/vit_b16_seed0_flax_sums.json``) are
    flax's."""
    _, want = init_vit("ViTB16", seed=0)
    got = V.init_flax_variables(zoo.build_module(zoo.BUILTIN_MODELS["ViTB16"]), seed=0)
    _ulp_check(want, got)
    with open(os.path.join(os.path.dirname(__file__), "resources",
                           "vit_b16_seed0_flax_sums.json")) as f:
        sums = json.load(f)
    flat = {"/".join(p.key for p in path): np.asarray(a, np.float64)
            for path, a in jax.tree_util.tree_flatten_with_path(want)[0]}
    assert sorted(flat) == sorted(sums)
    for key, a in flat.items():
        assert sums[key] == [float(a.sum()), float(np.abs(a).sum())], key
