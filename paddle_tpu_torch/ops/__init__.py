"""Op emitters: importing this package registers every op of the slices."""

from . import (  # noqa: F401
    activation,
    amp_ops,
    collective,
    detection,
    detection_ext,
    fused,
    kv_cache,
    math,
    math_ext,
    metrics,
    nn,
    optimizer_ops,
    random,
    sparse,
    tensor_ops,
)
