"""Synthetic access dataset (reference: cyber/dataset.py).

Generates per-tenant user→resource access logs with block structure: users
belong to departments that concentrate their accesses on that department's
resources — so cross-department accesses are the plantable anomalies.

The PyTorch port's copy of ``mmlspark_tpu.cyber.dataset``: host numpy,
unchanged, so that both packages give the same bits.
"""

from __future__ import annotations

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame


def synthetic_access_df(
    n_tenants: int = 1,
    n_departments: int = 3,
    users_per_dept: int = 10,
    resources_per_dept: int = 8,
    accesses_per_user: int = 20,
    cross_dept_prob: float = 0.02,
    seed: int = 0,
) -> DataFrame:
    rng = np.random.RandomState(seed)
    rows_t, rows_u, rows_r, rows_l = [], [], [], []
    for t in range(n_tenants):
        for d in range(n_departments):
            for u in range(users_per_dept):
                user = f"t{t}_d{d}_u{u}"
                for _ in range(accesses_per_user):
                    others = [x for x in range(n_departments) if x != d]
                    if others and rng.rand() < cross_dept_prob:
                        od = rng.choice(others)
                    else:
                        od = d
                    r = rng.randint(0, resources_per_dept)
                    rows_t.append(t)
                    rows_u.append(user)
                    rows_r.append(f"t{t}_d{od}_r{r}")
                    rows_l.append(1.0)
    return DataFrame.from_dict(
        {
            "tenant": np.array(rows_t, np.int64),
            "user": np.array(rows_u, dtype=object),
            "res": np.array(rows_r, dtype=object),
            "likelihood": np.array(rows_l, np.float64),
        }
    )
