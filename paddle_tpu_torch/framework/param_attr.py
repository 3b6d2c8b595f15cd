"""ParamAttr: the per-parameter configuration a layer's `weight_attr` /
`bias_attr` carries to `Layer.create_parameter`.

A copy of `paddle_tpu/framework/param_attr.py`: name, initializer,
learning-rate scale, regularizer, trainable and the gradient-clip toggle.
"""
from __future__ import annotations


class ParamAttr:
    def __init__(self, name=None, initializer=None, learning_rate=1.0,
                 regularizer=None, trainable=True, do_model_average=True,
                 need_clip=True):
        self.name = name
        self.initializer = initializer
        self.learning_rate = learning_rate
        self.regularizer = regularizer
        self.trainable = trainable
        self.do_model_average = do_model_average
        self.need_clip = need_clip

    def __repr__(self):
        return (f"ParamAttr(name={self.name!r}, lr={self.learning_rate}, "
                f"trainable={self.trainable}, need_clip={self.need_clip})")


__all__ = ["ParamAttr"]
