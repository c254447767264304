"""AccessAnomaly estimator (reference: cyber/anomaly/collaborative_filtering.py).

Per-tenant pipeline: index users/resources, optionally add complement
samples, factorize access likelihoods with device ALS, then standardize
predicted affinities per tenant so transform can emit
``anomaly_score = -(affinity - mean) / std`` — high score = the factor
model did not expect this user to touch this resource.

Unseen users/resources at transform time get score 0 (no evidence),
matching the reference's neutral handling.

The port of ``mmlspark_tpu.cyber.anomaly``: the label maps, the COO
aggregation, the complement draws and the standardisation are the JAX
package's host code; each tenant's ``als_train_coo`` runs on the
estimator's ``device`` (the card unless ``device="cpu"``).
"""

from __future__ import annotations

from typing import Any, Optional

import zlib

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.device import HasDevice, resolve_device
from mmlspark_tpu_torch.core.params import ComplexParam, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model
from mmlspark_tpu_torch.cyber.als import als_predict, als_train_coo
from mmlspark_tpu_torch.cyber.complement import complement_sample


class _AccessAnomalyParams(HasDevice):
    tenant_col = Param("tenant column", default="tenant")
    user_col = Param("user column", default="user")
    res_col = Param("resource column", default="res")
    likelihood_col = Param("access count/likelihood column", default="likelihood")
    output_col = Param("anomaly score output column", default="anomaly_score")
    rank = Param("ALS factor rank", default=10, type_=int)
    max_iter = Param("ALS iterations", default=10, type_=int)
    reg_param = Param("ALS regularization", default=0.1, type_=float)
    implicit = Param("implicit-feedback ALS (confidence weights)", default=False, type_=bool)
    alpha = Param("implicit confidence scale", default=40.0, type_=float)
    complement_factor = Param(
        "complement samples per observed row (explicit mode)", default=2.0, type_=float
    )
    seed = Param("rng seed", default=0, type_=int)


class AccessAnomaly(Estimator, _AccessAnomalyParams):
    def fit(self, df: DataFrame) -> "AccessAnomalyModel":
        dev = resolve_device(self.get("device"))
        tc = self.get("tenant_col")
        tenants = (
            df[tc] if tc in df.columns else np.zeros(df.count(), np.int64)
        )
        users_raw = df[self.get("user_col")]
        res_raw = df[self.get("res_col")]
        lc = self.get("likelihood_col")
        likes = (
            np.asarray(df[lc], np.float64)
            if lc in df.columns
            else np.ones(df.count(), np.float64)
        )

        per_tenant: dict = {}
        for t in np.unique(tenants) if len(tenants) else []:
            sel = np.asarray(tenants == t)
            u_labels = sorted(set(np.asarray(users_raw)[sel].tolist()))
            r_labels = sorted(set(np.asarray(res_raw)[sel].tolist()))
            u_map = {v: i for i, v in enumerate(u_labels)}
            r_map = {v: i for i, v in enumerate(r_labels)}
            u_idx = np.array([u_map[v] for v in np.asarray(users_raw)[sel]], np.int64)
            r_idx = np.array([r_map[v] for v in np.asarray(res_raw)[sel]], np.int64)
            vals = likes[sel]

            # sparse COO edges, duplicates aggregated — the ratings matrix
            # is never densified (Spark ALS consumes the same triples)
            keys = u_idx * len(r_labels) + r_idx
            uniq, inv = np.unique(keys, return_inverse=True)
            agg = np.zeros(len(uniq), np.float32)
            np.add.at(agg, inv, vals.astype(np.float32))
            eu = (uniq // len(r_labels)).astype(np.int64)
            er_ = (uniq % len(r_labels)).astype(np.int64)
            if not self.get("implicit") and self.get("complement_factor") > 0:
                cu, ci = complement_sample(
                    u_idx, r_idx, len(u_labels), len(r_labels),
                    self.get("complement_factor"),
                    # independent complement draws per tenant
                    self.get("seed") + (zlib.crc32(str(t).encode()) % (1 << 20)),
                )
                # observed zeros: rating-0 edges with full weight; drop any
                # that collide with real observations
                ckeys = cu * len(r_labels) + ci
                fresh = ~np.isin(ckeys, uniq)
                eu = np.concatenate([eu, cu[fresh]])
                er_ = np.concatenate([er_, ci[fresh]])
                agg = np.concatenate([agg, np.zeros(fresh.sum(), np.float32)])

            uf, rf = als_train_coo(
                eu, er_, agg,
                num_users=len(u_labels),
                num_items=len(r_labels),
                rank=min(self.get("rank"), max(1, min(len(u_labels), len(r_labels)) - 1)),
                iters=self.get("max_iter"),
                reg=self.get("reg_param"),
                implicit=self.get("implicit"),
                alpha=self.get("alpha"),
                seed=self.get("seed"),
                device=dev,
            )
            # standardization stats over the OBSERVED pairs' affinities
            obs_aff = als_predict(uf, rf, u_idx, r_idx)
            mean = float(obs_aff.mean()) if len(obs_aff) else 0.0
            std = float(obs_aff.std()) if len(obs_aff) > 1 else 1.0
            per_tenant[t] = {
                "user_labels": u_labels,
                "res_labels": r_labels,
                "user_factors": uf,
                "res_factors": rf,
                "mean": mean,
                "std": std if std > 0 else 1.0,
            }

        m = AccessAnomalyModel(**{k: v for k, v in self._paramMap.items()})
        m.set(tenant_models=per_tenant)
        return m


class AccessAnomalyModel(Model, _AccessAnomalyParams):
    tenant_models = ComplexParam("{tenant: factors + index maps + stats}")

    def transform(self, df: DataFrame) -> DataFrame:
        models = self.get_or_fail("tenant_models")
        tc = self.get("tenant_col")
        # label->index maps built once per transform, shared by all partitions
        maps = {
            t: (
                {v: i for i, v in enumerate(tm["user_labels"])},
                {v: i for i, v in enumerate(tm["res_labels"])},
            )
            for t, tm in models.items()
        }

        def fn(p: dict) -> dict:
            n = len(next(iter(p.values()))) if p else 0
            users = p[self.get("user_col")]
            res = p[self.get("res_col")]
            tenants = p[tc] if tc in p else np.zeros(n, np.int64)
            scores = np.zeros(n, np.float64)
            for t in set(tenants.tolist()) if n else set():
                tm = models.get(t)
                if tm is None:
                    continue  # unknown tenant: neutral 0
                u_map, r_map = maps[t]
                sel = np.where(np.asarray(tenants == t))[0]
                ui = np.array([u_map.get(users[pos], -1) for pos in sel], np.int64)
                ri = np.array([r_map.get(res[pos], -1) for pos in sel], np.int64)
                ok = (ui >= 0) & (ri >= 0)  # unseen entities stay neutral 0
                if ok.any():
                    aff = als_predict(
                        tm["user_factors"], tm["res_factors"], ui[ok], ri[ok]
                    )
                    scores[sel[ok]] = -(aff - tm["mean"]) / tm["std"]
            q = dict(p)
            q[self.get("output_col")] = scores
            return q

        return df.map_partitions(fn)
