"""Text featurization (featurize/text/*.scala).

TextFeaturizer = tokenize -> [stopwords] -> ngrams -> hashingTF -> [idf],
mirroring the reference's internal pipeline assembly
(TextFeaturizer.scala); MultiNGram concatenates several n-gram lengths;
PageSplitter chunks long strings by character budget.

The PyTorch port's copy of ``mmlspark_tpu.featurize.text``: host numpy
code in both packages, with the same outputs.
"""

from __future__ import annotations

import re
import numpy as np

from mmlspark_tpu_torch.core.dataframe import DataFrame, Partition
from mmlspark_tpu_torch.core.params import HasInputCol, HasOutputCol, Param
from mmlspark_tpu_torch.core.pipeline import Estimator, Model, Transformer
from mmlspark_tpu_torch.ops.hashing import hashing_tf

_DEFAULT_STOPWORDS = frozenset(
    "a an and are as at be by for from has he in is it its of on that the to was were will with".split()
)


def _tokenize(s: str, pattern: str, to_lower: bool, min_len: int) -> list:
    if to_lower:
        s = s.lower()
    toks = re.split(pattern, s)
    return [t for t in toks if len(t) >= min_len]


def _ngrams(tokens: list, n: int) -> list:
    if n <= 1:
        return list(tokens)
    return [" ".join(tokens[i: i + n]) for i in range(len(tokens) - n + 1)]


class TextFeaturizer(Estimator, HasInputCol, HasOutputCol):
    use_tokenizer = Param("tokenize input", default=True, type_=bool)
    tokenizer_pattern = Param("split regex", default=r"\s+", type_=str)
    to_lower_case = Param("lowercase", default=True, type_=bool)
    min_token_length = Param("min token length", default=0, type_=int)
    use_stop_words_remover = Param("remove stopwords", default=False, type_=bool)
    use_ngram = Param("emit n-grams", default=False, type_=bool)
    n_gram_length = Param("n", default=2, type_=int)
    num_features = Param("hash space", default=1 << 18, type_=int)
    binary = Param("binary term counts", default=False, type_=bool)
    use_idf = Param("apply inverse document frequency", default=True, type_=bool)
    min_doc_freq = Param("idf min document frequency", default=1, type_=int)

    def _docs(self, col: np.ndarray) -> list:
        docs = []
        for s in col:
            toks = (
                _tokenize(
                    str(s),
                    self.get("tokenizer_pattern"),
                    self.get("to_lower_case"),
                    self.get("min_token_length"),
                )
                if self.get("use_tokenizer")
                else list(s)
            )
            if self.get("use_stop_words_remover"):
                toks = [t for t in toks if t not in _DEFAULT_STOPWORDS]
            if self.get("use_ngram"):
                toks = _ngrams(toks, self.get("n_gram_length"))
            docs.append(toks)
        return docs

    def fit(self, df: DataFrame) -> "TextFeaturizerModel":
        model = TextFeaturizerModel(
            input_col=self.get_or_fail("input_col"),
            output_col=self.get_or_fail("output_col"),
        )
        for p in (
            "use_tokenizer tokenizer_pattern to_lower_case min_token_length "
            "use_stop_words_remover use_ngram n_gram_length num_features binary"
        ).split():
            model.set(p, self.get(p))
        if self.get("use_idf"):
            docs = self._docs(df[self.get_or_fail("input_col")])
            tf = hashing_tf(docs, self.get("num_features"), binary=True)
            n_docs = max(len(docs), 1)
            dfreq = tf.sum(axis=0)
            dfreq = np.where(dfreq >= self.get("min_doc_freq"), dfreq, 0.0)
            idf = np.log((n_docs + 1.0) / (dfreq + 1.0)).astype(np.float32)
            model.set(idf_vector=idf.tolist())
        return model


class TextFeaturizerModel(Model, HasInputCol, HasOutputCol):
    use_tokenizer = Param("tokenize input", default=True, type_=bool)
    tokenizer_pattern = Param("split regex", default=r"\s+", type_=str)
    to_lower_case = Param("lowercase", default=True, type_=bool)
    min_token_length = Param("min token length", default=0, type_=int)
    use_stop_words_remover = Param("remove stopwords", default=False, type_=bool)
    use_ngram = Param("emit n-grams", default=False, type_=bool)
    n_gram_length = Param("n", default=2, type_=int)
    num_features = Param("hash space", default=1 << 18, type_=int)
    binary = Param("binary term counts", default=False, type_=bool)
    idf_vector = Param("idf weights (set when use_idf)", type_=list)

    def transform(self, df: DataFrame) -> DataFrame:
        helper = TextFeaturizer()
        for p in (
            "use_tokenizer tokenizer_pattern to_lower_case min_token_length "
            "use_stop_words_remover use_ngram n_gram_length"
        ).split():
            helper.set(p, self.get(p))
        idf = self.get("idf_vector")
        idf_arr = np.asarray(idf, dtype=np.float32) if idf is not None else None

        def fn(p: Partition) -> np.ndarray:
            docs = helper._docs(p[self.get_or_fail("input_col")])
            tf = hashing_tf(docs, self.get("num_features"), binary=self.get("binary"))
            if idf_arr is not None:
                tf = tf * idf_arr
            return tf

        return df.with_column(self.get_or_fail("output_col"), fn)


class MultiNGram(Transformer, HasInputCol, HasOutputCol):
    """Concatenate n-grams of several lengths (featurize/text/MultiNGram.scala).
    Input: token-array column; output: object column of combined n-gram lists."""

    lengths = Param("n-gram lengths", default=[1, 2, 3], type_=list)

    def transform(self, df: DataFrame) -> DataFrame:
        lengths = self.get("lengths")
        ic, oc = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def fn(p: Partition) -> np.ndarray:
            out = np.empty(len(p[ic]), dtype=object)
            for i, toks in enumerate(p[ic]):
                toks = list(toks)
                combined: list = []
                for n in lengths:
                    combined.extend(_ngrams(toks, int(n)))
                out[i] = combined
            return out

        return df.with_column(oc, fn)


class PageSplitter(Transformer, HasInputCol, HasOutputCol):
    """Split long strings into page chunks (featurize/text/PageSplitter.scala):
    word-boundary preferred, hard split beyond maximum."""

    maximum_page_length = Param("max chars per page", default=5000, type_=int)
    minimum_page_length = Param("min chars before boundary split", default=4500, type_=int)
    boundary_regex = Param("boundary pattern", default=r"\s", type_=str)

    def transform(self, df: DataFrame) -> DataFrame:
        mx = self.get("maximum_page_length")
        mn = self.get("minimum_page_length")
        pat = re.compile(self.get("boundary_regex"))
        ic, oc = self.get_or_fail("input_col"), self.get_or_fail("output_col")

        def split_one(s: str) -> list:
            pages = []
            i = 0
            while i < len(s):
                chunk = s[i: i + mx]
                if i + mx >= len(s):
                    pages.append(chunk)
                    break
                cut = None
                for m in pat.finditer(chunk, mn):
                    cut = m.start()
                cut = cut if cut is not None else mx
                pages.append(chunk[:cut])
                i += cut if cut > 0 else mx
            return pages

        def fn(p: Partition) -> np.ndarray:
            out = np.empty(len(p[ic]), dtype=object)
            for i, s in enumerate(p[ic]):
                out[i] = split_one(str(s))
            return out

        return df.with_column(oc, fn)
