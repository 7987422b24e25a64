"""Serving: freeze a program and answer batched requests from it, and
generate GPT tokens through the KV cache."""

from .freeze import FrozenModel, freeze_program  # noqa: F401
from .generate import GPTGenerateRunner, GPTGenerator  # noqa: F401
from .router import (  # noqa: F401
    Endpoint,
    EndpointConfig,
    FrozenRunner,
    Server,
    ServerDrainingError,
)
