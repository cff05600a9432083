"""Optimizers, gradient clipping and LR schedulers of the port
(`paddle_tpu/optimizer/`)."""
from . import lr
from .clip import ClipGradByGlobalNorm, ClipGradByNorm, ClipGradByValue
from .optimizer import (SGD, Adadelta, Adagrad, Adam, Adamax, AdamW, Lamb,
                        Lars, Momentum, Optimizer, RMSProp)

__all__ = ["Optimizer", "SGD", "Momentum", "Adam", "AdamW", "Adamax",
           "Adagrad", "Adadelta", "RMSProp", "Lamb", "Lars", "lr",
           "ClipGradByValue", "ClipGradByNorm", "ClipGradByGlobalNorm"]
