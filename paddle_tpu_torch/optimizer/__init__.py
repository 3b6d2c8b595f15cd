"""paddle.optimizer counterpart: every optimizer of the reference, the
lr schedulers (`optimizer.lr`), and `L1Decay` / `L2Decay`.

The decay objects carry only `_coeff`, and the optimizers read only that
(the reference's `optimizer/optimizer.py:45`): `L1Decay(c)` adds `c * p`
to the gradient, an L2 term, as `L2Decay(c)` does (a kept reference
defect, ROADMAP Queue 3).
"""
from . import lr  # noqa: F401
from .adam import (Adadelta, Adagrad, Adam, AdamW, Adamax,  # noqa: F401
                   Lamb, LarsMomentum, RMSProp)
from .optimizer import SGD, Momentum, Optimizer  # noqa: F401


class L2Decay:
    """paddle.regularizer.L2Decay: the coefficient an optimizer reads."""

    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)
