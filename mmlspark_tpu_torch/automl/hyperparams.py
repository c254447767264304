"""Hyperparameter spaces (automl/HyperparamBuilder.scala, ParamSpace,
GridSpace/RandomSpace, DefaultHyperparams).

The PyTorch port's copy of ``mmlspark_tpu.automl.hyperparams`` (pure
Python): the same seed draws the same param maps in both packages."""

from __future__ import annotations

import itertools
import random
from typing import Any, Iterator, Sequence


class DiscreteHyperParam:
    def __init__(self, values: Sequence[Any]):
        self.values = list(values)

    def sample(self, rng: random.Random) -> Any:
        return rng.choice(self.values)

    def grid(self) -> list:
        return self.values


class RangeHyperParam:
    def __init__(self, low: Any, high: Any, is_int: bool = False, log: bool = False):
        self.low, self.high, self.is_int, self.log = low, high, is_int, log

    def sample(self, rng: random.Random) -> Any:
        import math

        if self.log:
            v = math.exp(rng.uniform(math.log(self.low), math.log(self.high)))
        else:
            v = rng.uniform(self.low, self.high)
        return int(round(v)) if self.is_int else v

    def grid(self, n: int = 3) -> list:
        step = (self.high - self.low) / max(n - 1, 1)
        vals = [self.low + i * step for i in range(n)]
        return [int(round(v)) for v in vals] if self.is_int else vals


class HyperparamBuilder:
    """Collects (param_name, space) pairs (HyperparamBuilder analogue)."""

    def __init__(self) -> None:
        self._spaces: list = []

    def add_hyperparam(self, name: str, space: Any) -> "HyperparamBuilder":
        self._spaces.append((name, space))
        return self

    def build(self) -> list:
        return list(self._spaces)


class GridSpace:
    """Cartesian product of discrete grids."""

    def __init__(self, spaces: Sequence[tuple]):
        self.spaces = list(spaces)

    def param_maps(self) -> Iterator[dict]:
        names = [n for n, _ in self.spaces]
        grids = [s.grid() if hasattr(s, "grid") else list(s) for _, s in self.spaces]
        for combo in itertools.product(*grids):
            yield dict(zip(names, combo))


class RandomSpace:
    """Random draws from each space."""

    def __init__(self, spaces: Sequence[tuple], seed: int = 0):
        self.spaces = list(spaces)
        self.seed = seed

    def param_maps(self, n: int = 10) -> Iterator[dict]:
        rng = random.Random(self.seed)
        for _ in range(n):
            yield {name: s.sample(rng) for name, s in self.spaces}


class DefaultHyperparams:
    """Per-algorithm default search ranges (automl/DefaultHyperparams.scala)."""

    @staticmethod
    def logistic_regression() -> list:
        return (
            HyperparamBuilder()
            .add_hyperparam("reg_param", RangeHyperParam(1e-5, 1e-1, log=True))
            .add_hyperparam("learning_rate", DiscreteHyperParam([0.1, 0.3, 1.0]))
            .build()
        )

    @staticmethod
    def gbdt() -> list:
        return (
            HyperparamBuilder()
            .add_hyperparam("num_leaves", DiscreteHyperParam([15, 31, 63]))
            .add_hyperparam("learning_rate", RangeHyperParam(0.02, 0.3, log=True))
            .add_hyperparam("num_iterations", DiscreteHyperParam([50, 100]))
            .build()
        )
