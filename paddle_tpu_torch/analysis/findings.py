"""Structured findings produced by the program verifier before a run
(counterpart of paddle_tpu/analysis/findings.py).

A Finding is one defect (or observation) anchored to an op: severity, a
stable category slug (tests grep these), the offending names, and the
op's ``__loc__`` attr where a program carries one (the JAX package's
Operators record the user frame that built them; a program the port
reads from the JAX package's files keeps it).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field


class Severity(enum.IntEnum):
    """INFO: stylistic/dead code — never fails a build.
    WARNING: suspicious but runnable (silent redefinition, a collective
    over an axis the mesh does not bind, ...).
    ERROR: the program will fail to run, compute garbage, or deadlock a
    multi-rank run; strict mode refuses to run it."""

    INFO = 0
    WARNING = 1
    ERROR = 2


# categories (stable slugs, the JAX package's; tests key on these)
USE_BEFORE_DEF = "use-before-def"
UNDECLARED_VAR = "undeclared-var"
UNDECLARED_WRITE = "undeclared-write"
REDEFINITION = "redefinition"
UNKNOWN_OP = "unknown-op"
DEAD_OP = "dead-op"
UNREACHABLE_VAR = "unreachable-var"
SHAPE_DESYNC = "shape-desync"
DTYPE_DESYNC = "dtype-desync"
TRAINING_OP_IN_INFERENCE = "training-op-in-inference"
COLLECTIVE_DIVERGENCE = "collective-divergence"
COLLECTIVE_BRANCH_DIVERGENCE = "collective-branch-divergence"
UNKNOWN_MESH_AXIS = "unknown-mesh-axis"
MISSING_FEED = "missing-feed"
OOM_RISK = "oom-risk"
USE_AFTER_DONATE = "use-after-donate"
MISSED_DONATION = "missed-donation"
RECOMPUTE_NO_SAVINGS = "recompute-no-savings"

# WARNING findings in these categories count as errors under strict
# verify (the redefinition satellite: "warn; error under strict";
# oom-risk: an over-HBM-budget program is refused pre-compile)
STRICT_ESCALATIONS = frozenset({REDEFINITION, OOM_RISK})


@dataclass
class Finding:
    severity: Severity
    category: str
    message: str
    block_idx: int = 0
    op_index: int | None = None
    op_type: str | None = None
    names: tuple = ()
    loc: str | None = None  # user source frame that created the op/var

    def to_dict(self) -> dict:
        """Stable machine-readable form (the field names are the JAX
        package's)."""
        return {
            "severity": self.severity.name,
            "category": self.category,
            "message": self.message,
            "block_idx": self.block_idx,
            "op_index": self.op_index,
            "op_type": self.op_type,
            "names": list(self.names),
            "loc": self.loc,
        }

    def format(self) -> str:
        where = []
        if self.op_index is not None:
            where.append(f"op #{self.op_index}")
        if self.op_type:
            where.append(f"{self.op_type!r}")
        if self.block_idx:
            where.append(f"block {self.block_idx}")
        if self.loc:
            where.append(f"created at {self.loc}")
        suffix = f"  [{', '.join(where)}]" if where else ""
        return f"{self.severity.name}[{self.category}] {self.message}{suffix}"


def finding_for_op(severity, category, message, op=None, op_index=None,
                   block_idx=0, names=()):
    """Build a Finding anchored to an Operator, pulling its ``__loc__``."""
    return Finding(
        severity=severity,
        category=category,
        message=message,
        block_idx=block_idx,
        op_index=op_index,
        op_type=getattr(op, "type", None),
        names=tuple(names),
        loc=op.attr("__loc__") if hasattr(op, "attr") else None,
    )


@dataclass
class Report:
    """The verifier's output: an ordered finding list plus helpers."""

    findings: list = field(default_factory=list)

    def add(self, finding: Finding) -> None:
        self.findings.append(finding)

    def extend(self, findings) -> None:
        self.findings.extend(findings)

    @property
    def errors(self):
        return [f for f in self.findings if f.severity == Severity.ERROR]

    @property
    def warnings(self):
        return [f for f in self.findings if f.severity == Severity.WARNING]

    @property
    def infos(self):
        return [f for f in self.findings if f.severity == Severity.INFO]

    def by_category(self, category):
        return [f for f in self.findings if f.category == category]

    def strict_errors(self):
        """Errors under strict mode: ERROR findings plus WARNING findings
        in the escalated categories (silent redefinition)."""
        return [
            f for f in self.findings
            if f.severity == Severity.ERROR
            or (f.severity == Severity.WARNING
                and f.category in STRICT_ESCALATIONS)
        ]

    @property
    def ok(self) -> bool:
        return not self.errors

    def render(self, min_severity=Severity.INFO,
               max_per_severity=25) -> str:
        """Human rendering, capped at ``max_per_severity`` findings per
        severity so a detection-sized program doesn't flood the single
        ``ProgramVerifyWarning`` — the elided tail is summarized per
        category; the full list stays on the Report / exception object.
        ``max_per_severity=None`` renders everything."""
        picked = [
            f for f in sorted(
                self.findings, key=lambda f: -int(f.severity)
            )
            if f.severity >= min_severity
        ]
        if not picked:
            return "program verifier: clean bill (no findings)"
        head = (
            f"program verifier: {len(self.errors)} error(s), "
            f"{len(self.warnings)} warning(s), {len(self.infos)} info"
        )
        lines = [head]
        for sev in (Severity.ERROR, Severity.WARNING, Severity.INFO):
            group = [f for f in picked if f.severity == sev]
            shown = group if max_per_severity is None else (
                group[:max_per_severity]
            )
            lines.extend("  " + f.format() for f in shown)
            hidden = group[len(shown):]
            if hidden:
                by_cat = {}
                for f in hidden:
                    by_cat[f.category] = by_cat.get(f.category, 0) + 1
                cats = ", ".join(
                    f"{c} x{n}" for c, n in sorted(by_cat.items())
                )
                lines.append(
                    f"  … +{len(hidden)} more {sev.name} "
                    f"finding(s) ({cats})"
                )
        return "\n".join(lines)
