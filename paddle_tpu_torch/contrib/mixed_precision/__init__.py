"""fluid.contrib.mixed_precision (counterpart of
paddle_tpu/contrib/mixed_precision): the AMP program rewrite and the
optimizer decorator."""

from .decorator import OptimizerWithMixedPrecision, decorate  # noqa: F401
from .fp16_lists import AutoMixedPrecisionLists  # noqa: F401
from .fp16_utils import rewrite_program  # noqa: F401
