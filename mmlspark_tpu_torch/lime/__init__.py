"""Model interpretability, LIME (reference: lime/, SURVEY.md §2.13): the
port of ``mmlspark_tpu.lime``.

The reference explains predictions by sampling perturbed inputs, scoring
them with the model, and fitting a local sparse linear surrogate per row
(LIME.scala:30-41, LassoUtils.lasso at BreezeUtils.scala:112). Here the
local problem lives on the stage's device: sample and state generation,
image censoring, SLIC and the lasso; only the inner model call crosses
through the pipeline API.
"""

from mmlspark_tpu_torch.lime.lasso import batched_lasso, lasso
from mmlspark_tpu_torch.lime.lime import ImageLIME, TabularLIME, TabularLIMEModel
from mmlspark_tpu_torch.lime.superpixel import Superpixel, SuperpixelTransformer, slic

__all__ = [
    "lasso",
    "batched_lasso",
    "slic",
    "Superpixel",
    "SuperpixelTransformer",
    "TabularLIME",
    "TabularLIMEModel",
    "ImageLIME",
]
