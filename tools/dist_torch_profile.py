"""Distributed training of the PyTorch port across the cards of one host.

    python3 tools/dist_torch_profile.py [--worlds 2,4]

For each world size W (default: every card of the host), starts W
processes, one per card, joined by NCCL, and prints one JSON line each.
The ranks run ``chip_smoke.py``'s distributed phase (``spawn_ranks`` and
``check_ranks`` there) with a card a rank in place of two gloo ranks on
one card:

- ``b4``: the histograms' distributed form (200,000 x 64 uint8 bins split
  in W blocks; B = 64 and 256, the B=256 plane masked, a cube of S = 16):
  every rank's planes bitwise one ``plane_hist`` / ``multi_plane_hist``
  call on all the rows (made on card 0), every fixed-scale entry bitwise
  its plain version on the rank's rows; each rank's fixed-scale kernel
  (eager and in a CUDA graph), its all-reduce of the int64 cells and its
  whole build;
- ``fits``: the trees/s cell (63 leaves, 20 rounds) with data_parallel
  lossguide and depthwise and voting_parallel (K = 4), each rank fitting
  its block: trees/s, held-out AUC against the one-device fit on card 0,
  every rank's model byte-identical, bytes all-reduced a split; the
  integer-column fit (max_bin 63) against the one-device model string;
  VW's V2 pipeline (3 passes) against one device.

The one-device references are fitted on card 0 by this process before the
ranks start (a fit in a process of a group of W ranks takes the W-rank
path). Fails (nonzero exit) if a plane, a model or a quality bound
disagrees. Needs ``world`` cards; exits nonzero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as C  # noqa: E402  (exits nonzero without a CUDA device)


def _references() -> dict:
    """One-device references on this card: the trees/s cell's AUCs, the
    integer fit's model string, V2's AUC, and the B4 planes of one call."""
    x_all, y_all = C.dataset(C.N + C.N_TEST)
    x, y, xt, yt = x_all[:C.N], y_all[:C.N], x_all[C.N:], y_all[C.N:]
    tr = C.DataFrame.from_dict({"features": x, "label": y})
    kw = dict(num_iterations=20, num_leaves=63, min_data_in_leaf=20, seed=0, device="cuda")
    auc = {p: C.classifier_score(xt, yt)(C.LightGBMClassifier(**kw, growth_policy=p).fit(tr))["auc"]
           for p in ("lossguide", "depthwise")}
    xi, yi = C.int_dataset(C.N)
    integer = C.LightGBMClassifier(**kw, max_bin=63).fit(
        C.DataFrame.from_dict({"features": xi, "label": yi})).get("model_string")
    return {"backend": "nccl", "auc": auc, "integer": integer,
            "vw_auc": C.vw_v2_block(0, 1)["auc"], "one_call": C._b4_one_call()}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--worlds", default=str(torch.cuda.device_count()),
                    help="comma-separated world sizes, each at most the card count")
    args = ap.parse_args()
    smi = C.card()
    C.build()
    worlds = [int(w) for w in args.worlds.split(",")]
    if max(worlds) > torch.cuda.device_count():
        sys.exit(f"needs {max(worlds)} cards, found {torch.cuda.device_count()}")
    ref = _references()
    fails = []
    for world in worlds:
        ranks, spawn_s = C.spawn_ranks(world, "nccl", card_per_rank=True)
        bad, rec = C.check_ranks(ranks, ref)
        print(json.dumps({"tool": "dist_torch_profile", "world": world, "nvidia_smi": smi,
                          "spawn_s": spawn_s, **rec, "fails": bad}), flush=True)
        fails += bad
    if fails:
        sys.exit("; ".join(fails))


if __name__ == "__main__":
    main()
