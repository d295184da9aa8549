"""Decentralized learning methods and the plain per-node optimizers
(port of ``repro/optim``)."""
from .decentralized import METHOD_NAMES, Method, make_method  # noqa: F401
from .sgd import (adamw_init, adamw_update, momentum_init,  # noqa: F401
                  momentum_update)
