"""Host-side text stages: trie find/replace, unicode normalization
(stages/TextPreprocessor.scala, stages/UnicodeNormalize.scala).

The PyTorch port's copy of ``mmlspark_tpu.stages.text``: host numpy
code in both packages, with the same outputs.
"""

from __future__ import annotations

import unicodedata
from typing import Any

import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame
from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Transformer


class _Trie:
    """Longest-match replacement trie (TextPreprocessor's Trie analogue)."""

    __slots__ = ("children", "value")

    def __init__(self) -> None:
        self.children: dict = {}
        self.value: Any = None

    def put(self, key: str, value: str) -> None:
        node = self
        for ch in key:
            node = node.children.setdefault(ch, _Trie())
        node.value = value

    def replace_all(self, text: str) -> str:
        out = []
        i, n = 0, len(text)
        while i < n:
            node, j, best, best_j = self, i, None, i
            while j < n and text[j] in node.children:
                node = node.children[text[j]]
                j += 1
                if node.value is not None:
                    best, best_j = node.value, j
            if best is not None:
                out.append(best)
                i = best_j
            else:
                out.append(text[i])
                i += 1
        return "".join(out)


class TextPreprocessor(Transformer, HasInputCol, HasOutputCol):
    """Map/replace substrings via trie with optional normalization first."""

    map = Param("substring -> replacement map", default={}, type_=dict)
    normFunc = Param("none|lower|upper (applied before matching)", default="none", type_=str)

    def transform(self, df: DataFrame) -> DataFrame:
        trie = _Trie()
        for k, v in self.get("map").items():
            trie.put(k, v)
        norm = {"none": lambda s: s, "lower": str.lower, "upper": str.upper}[
            self.get("normFunc")
        ]
        ic, oc = self.get_or_fail("input_col"), self.get_or_fail("output_col")
        return df.with_column(
            oc, lambda p: np.array([trie.replace_all(norm(str(s))) for s in p[ic]], dtype=object)
        )


class UnicodeNormalize(Transformer, HasInputCol, HasOutputCol):
    form = Param("NFC|NFD|NFKC|NFKD", default="NFKD", type_=str)
    lower = Param("lowercase output", default=True, type_=bool)

    def transform(self, df: DataFrame) -> DataFrame:
        ic, oc = self.get_or_fail("input_col"), self.get_or_fail("output_col")
        form = self.get("form")
        lower = self.get("lower")

        def f(s: Any) -> str:
            t = unicodedata.normalize(form, str(s))
            return t.lower() if lower else t

        return df.with_column(
            oc, lambda p: np.array([f(s) for s in p[ic]], dtype=object)
        )
