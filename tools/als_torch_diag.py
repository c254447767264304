"""Where ALS on the card parts from ALS on the CPU, on one H100.

    python3 tools/als_torch_diag.py [--users 500] [--iters 10]

On the first ``--users`` users' edges of ``chip_smoke.movielens_like()``
(rank 10): how many values of the seeded normal draw differ between the
card's ``models.resnet.normal`` and the CPU's, and by how many ulp; whether
the first half-step's grams (user and item side) and the solves on the
same inputs are bitwise card vs CPU; and the gap ``max|uf @ rf.T| card vs
CPU`` after 1, 2, 5 and 10 iterations, from the host's draw (what
``cyber.als`` runs) and from each device's own draw. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as c  # noqa: E402
from mmlspark_tpu_torch.cyber import als as A  # noqa: E402
from mmlspark_tpu_torch.lime.lime import prng_key, split  # noqa: E402
from mmlspark_tpu_torch.models.resnet import normal  # noqa: E402


def _own_draws(seed: int, n_users: int, n_items: int, rank: int, device) -> tuple:
    """The draw made on ``device`` itself."""
    scale = torch.tensor(np.float32(0.1), device=device)
    return tuple(scale * normal(k, (n, rank), device=device)
                 for k, n in zip(split(prng_key(seed)), (n_users, n_items)))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--users", type=int, default=500)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    cols = c.movielens_like()
    sel = cols["user_idx"] < args.users
    u, i, r = cols["user_idx"][sel], cols["item_idx"][sel], cols["rating"][sel]
    n_u, n_i, rank, seed = args.users, c.ML_ITEMS, 10, 0
    cpu, gpu = torch.device("cpu"), torch.device("cuda")
    out = {"nvidia_smi": c.card(), "edges": int(sel.sum())}

    yc = _own_draws(seed, n_u, n_i, rank, cpu)[1].numpy()
    yg = _own_draws(seed, n_u, n_i, rank, gpu)[1].cpu().numpy()
    ulp = np.abs(yc.view(np.int32).astype(np.int64) - yg.view(np.int32).astype(np.int64))
    out["draw_values_differing"] = int((ulp > 0).sum())
    out["draw_max_ulp"] = int(ulp.max())

    edges = {}
    for dev in (cpu, gpu):
        pad = (-len(u)) % A._EDGE_BLOCK
        edges[dev.type] = [torch.as_tensor(np.pad(v, (0, pad)), device=dev) for v in (
            u.astype(np.int64), i.astype(np.int64), r, np.ones(len(u), np.float32))]
    y = torch.as_tensor(yc)
    eye = torch.eye(rank) * np.float32(0.1)
    side = {}
    for dev in (cpu, gpu):
        eu, ei, er, ew = edges[dev.type]
        a, b = A._accumulate(y.to(dev), eu, ei, er, ew, n_u, False)
        x = A._solve(a + eye.to(dev), b)
        a2, _ = A._accumulate(x, ei, eu, er, ew, n_i, False)
        side[dev.type] = [t.cpu() for t in (a, b, x, a2)]
    for k, name in enumerate(("user_grams", "user_rhs", "solve", "item_grams")):
        out[f"{name}_bitwise"] = bool(torch.equal(side["cpu"][k], side["cuda"][k]))

    def gaps(draws: "dict | None") -> dict:
        res = {}
        for iters in sorted({1, 2, 5, args.iters}):
            fits = {}
            for dev in (cpu, gpu):
                if draws is not None:
                    A.initial_factors = draws[dev.type]
                fits[dev.type] = A.als_train_coo(u, i, r, n_u, n_i, rank=rank, iters=iters,
                                                 seed=seed, device=dev)
            ref = fits["cpu"][0] @ fits["cpu"][1].T
            got = fits["cuda"][0] @ fits["cuda"][1].T
            res[iters] = float(np.abs(got - ref).max() / np.abs(ref).max())
        return res

    host = A.initial_factors
    out["gap_host_draw"] = gaps(None)
    out["gap_own_draws"] = gaps({"cpu": lambda s, nu, ni, k, d: _own_draws(s, nu, ni, k, cpu),
                                 "cuda": lambda s, nu, ni, k, d: _own_draws(s, nu, ni, k, gpu)})
    A.initial_factors = host
    print(json.dumps(out))


if __name__ == "__main__":
    main()
