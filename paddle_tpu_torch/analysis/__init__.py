"""Static program analysis over the Program IR (counterpart of
paddle_tpu/analysis): verification before a run, the per-op cost model
and the static memory plan. The families return structured
:class:`Finding`\\ s:

* structural  — use-before-def vs feeds/persistables/scope, undeclared
  reads/writes, silent name redefinition, unknown op types, dead ops and
  unreachable variables (structural.py);
* shape/dtype — per-op replay of ``registry.infer_shapes`` cross-checked
  against every declared Variable, with -1/BATCH_SENTINEL handling
  (shapes.py);
* collective schedule — per-rank simulation of the op streams of a
  program on a mesh; order/kind/axis must agree across ranks and every
  axis must exist in the Program's mesh (collectives.py);
* memory/liveness — per-op live-interval simulation producing the static
  peak-HBM plan (resident persistables, transient peak, watermark op),
  the donation/aliasing verifier (use-after-donate, missed-donation,
  recompute-no-savings), and the ``PADDLE_TPU_HBM_BYTES`` oom-risk gate
  (memory.py).

cost.py counts each op's FLOPs and bytes (``Program.estimate``), the
numerator of the executor's ``perf.mfu`` gauge. The executor runs the
verifier where it builds a plan, behind ``PADDLE_TPU_VERIFY`` (``strict``
| ``warn`` (default) | ``0``). Every rule is the JAX package's, so one
program gives one answer in both packages.
"""

from __future__ import annotations

from .findings import (  # noqa: F401
    COLLECTIVE_BRANCH_DIVERGENCE,
    COLLECTIVE_DIVERGENCE,
    DEAD_OP,
    DTYPE_DESYNC,
    MISSED_DONATION,
    MISSING_FEED,
    OOM_RISK,
    RECOMPUTE_NO_SAVINGS,
    REDEFINITION,
    SHAPE_DESYNC,
    STRICT_ESCALATIONS,
    UNDECLARED_VAR,
    UNDECLARED_WRITE,
    UNKNOWN_MESH_AXIS,
    UNKNOWN_OP,
    UNREACHABLE_VAR,
    USE_AFTER_DONATE,
    USE_BEFORE_DEF,
    Finding,
    Report,
    Severity,
)
from .collectives import analyze_collectives, collective_axis  # noqa: F401
from .cost import (  # noqa: F401
    CostTable,
    OpCost,
    estimate_program,
    family_of,
    op_cost,
    peak_flops,
)
from .memory import (  # noqa: F401
    MemoryTable,
    analyze_memory,
    hbm_budget,
    plan_memory,
)
from .shapes import analyze_shapes  # noqa: F401
from .structural import analyze_structural  # noqa: F401
from .verify import (  # noqa: F401
    check_before_compile,
    set_verify_mode,
    verify_mode,
    verify_program,
)
