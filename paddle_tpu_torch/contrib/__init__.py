"""contrib: mixed precision (AMP) (counterpart of paddle_tpu/contrib;
quantization-aware training comes with a later slice)."""

from . import mixed_precision  # noqa: F401
