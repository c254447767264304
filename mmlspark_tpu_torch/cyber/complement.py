"""Complement sampling (reference: cyber/anomaly/complement_access.py).

For explicit-feedback anomaly training the reference augments observed
accesses with sampled UNSEEN (user, resource) pairs given a low rating, so
the factor model learns to separate seen from unseen. ``complement_sample``
draws uniformly from the complement of the access set without
materializing the full U×I grid.

The PyTorch port's copy of ``mmlspark_tpu.cyber.complement``: host numpy,
unchanged, so that both packages give the same bits.
"""

from __future__ import annotations

from typing import Any, Optional

import zlib

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import Param
from mmlspark_tpu_torch.core.pipeline import Transformer


def complement_sample(
    users: np.ndarray,
    items: np.ndarray,
    n_users: int,
    n_items: int,
    factor: float = 2.0,
    seed: int = 0,
    user_pool: Optional[np.ndarray] = None,
    item_pool: Optional[np.ndarray] = None,
) -> tuple:
    """Sample ~factor * len(users) (u, i) pairs NOT present in the input set.

    The sampling universe is ``user_pool × item_pool`` when given (use the
    tenant's own observed entities for globally-indexed multi-tenant data),
    else ``range(n_users) × range(n_items)``.
    """
    upool = np.asarray(user_pool if user_pool is not None else np.arange(n_users), np.int64)
    ipool = np.asarray(item_pool if item_pool is not None else np.arange(n_items), np.int64)
    seen = set(zip(users.tolist(), items.tolist()))
    target = int(factor * len(users))
    total_free = len(upool) * len(ipool) - len(seen)
    target = min(target, max(total_free, 0))
    rng = np.random.RandomState(seed)
    out_u, out_i = [], []
    picked: set = set()
    # rejection sampling; dense fallback when the complement is tiny
    attempts = 0
    while len(out_u) < target and attempts < 50 * max(target, 1):
        u = int(upool[rng.randint(0, len(upool))])
        i = int(ipool[rng.randint(0, len(ipool))])
        attempts += 1
        if (u, i) in seen or (u, i) in picked:
            continue
        picked.add((u, i))
        out_u.append(u)
        out_i.append(i)
    if len(out_u) < target:  # dense enumeration of what's left
        for u in upool.tolist():
            for i in ipool.tolist():
                if len(out_u) >= target:
                    break
                if (u, i) not in seen and (u, i) not in picked:
                    picked.add((u, i))
                    out_u.append(u)
                    out_i.append(i)
    return np.array(out_u, np.int64), np.array(out_i, np.int64)


class ComplementSampler(Transformer):
    """DataFrame stage: appends complement (user, item) rows with a fixed
    low rating (per tenant when partition_key is set)."""

    partition_key = Param("tenant column; None = single tenant", default=None)
    user_col = Param("indexed user column", default="user_idx")
    item_col = Param("indexed resource column", default="res_idx")
    rating_col = Param("rating column", default="rating")
    complement_rating = Param("rating for sampled complement rows", default=0.0, type_=float)
    factor = Param("complement rows per observed row", default=2.0, type_=float)
    seed = Param("rng seed", default=0, type_=int)

    def transform(self, df: DataFrame) -> DataFrame:
        uc, ic, rc = self.get("user_col"), self.get("item_col"), self.get("rating_col")
        pk = self.get("partition_key")
        data = df.to_dict()
        users = np.asarray(data[uc], np.int64)
        items = np.asarray(data[ic], np.int64)
        tenants = data[pk] if pk is not None else np.zeros(len(users), np.int64)

        new_cols: dict = {c: [v] for c, v in data.items()}
        for t in np.unique(tenants):
            sel = tenants == t
            tu, ti = users[sel], items[sel]
            cu, ci = complement_sample(
                tu, ti, 0, 0,
                self.get("factor"),
                # independent draws per tenant
                self.get("seed") + (zlib.crc32(str(t).encode()) % (1 << 20)),
                user_pool=np.unique(tu),
                item_pool=np.unique(ti),
            )
            if not len(cu):
                continue
            add = {
                uc: cu,
                ic: ci,
                rc: np.full(len(cu), self.get("complement_rating"), np.float64),
            }
            if pk is not None:
                add[pk] = np.full(len(cu), t, dtype=np.asarray(tenants).dtype)
            for c in new_cols:
                if c in add:
                    new_cols[c].append(add[c])
                else:  # pad untouched columns with zeros/empties of same dtype
                    proto = np.asarray(data[c])
                    pad = np.zeros(len(cu), dtype=proto.dtype) if proto.dtype != object else np.array([None] * len(cu), dtype=object)
                    new_cols[c].append(pad)
        return DataFrame.from_dict({c: np.concatenate(vs) for c, vs in new_cols.items()})
