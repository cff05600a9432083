"""paddle_tpu_torch.nn — the port of `paddle_tpu/nn`: the layer base
(`Layer`, `Parameter`, `ParamAttr`), `initializer`, the common, conv,
pooling, norm, container, activation and transformer layers,
`CrossEntropyLoss`, and `functional`, each in the JAX package's
positional signatures."""
from . import functional, initializer
from . import (activation, common, container, conv, loss, norm, pooling,
               transformer)
from .layer import Layer, Parameter, ParamAttr
from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .container import *  # noqa: F401,F403
from .conv import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .pooling import *  # noqa: F401,F403
from .transformer import *  # noqa: F401,F403

__all__ = (["Layer", "Parameter", "ParamAttr", "functional", "initializer"]
           + list(common.__all__) + list(conv.__all__)
           + list(pooling.__all__) + list(norm.__all__)
           + list(container.__all__) + list(activation.__all__)
           + list(loss.__all__) + list(transformer.__all__))
