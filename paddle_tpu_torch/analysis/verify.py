"""Verifier orchestration: run the analysis families (structural, shape/
dtype, collective schedule, memory/liveness) over a Program and act on
the result per ``PADDLE_TPU_VERIFY`` (counterpart of
paddle_tpu/analysis/verify.py).

Modes (env var, overridable per-process with :func:`set_verify_mode`):
* ``strict`` — ERROR findings (plus escalated WARNINGs, e.g. silent
  redefinition) refuse the run with a typed
  :class:`~paddle_tpu_torch.errors.ProgramVerifyError` carrying the
  findings.
* ``warn`` (default) — ERROR/WARNING findings surface as one
  :class:`~paddle_tpu_torch.errors.ProgramVerifyWarning`; the run
  proceeds.
* ``0`` / ``off`` — the executor hook is a no-op.

The executor calls :func:`check_before_compile` where it builds a plan
(a plan-cache miss, where the JAX package compiles). The pass is cached
per (program version, feed set, fetch set): new plans of the same
program at new feed shapes do not re-verify. Telemetry:
``analysis.programs_verified``, ``analysis.findings.{error,warning,info}``
counters and the ``analysis.verify_latency`` histogram.
"""

from __future__ import annotations

import os
import warnings

from .collectives import analyze_collectives
from .findings import Report, Severity
from .memory import analyze_memory
from .shapes import analyze_shapes
from .structural import analyze_structural

_MODES = ("strict", "warn", "off")
_mode_override = None


def verify_mode() -> str:
    """Resolve the active mode: programmatic override, else env, else warn."""
    if _mode_override is not None:
        return _mode_override
    raw = os.environ.get("PADDLE_TPU_VERIFY", "warn").strip().lower()
    if raw in ("0", "off", "false", "no", "none", ""):
        return "off"
    if raw == "strict":
        return "strict"
    return "warn"


def set_verify_mode(mode) -> None:
    """Override ``PADDLE_TPU_VERIFY`` for this process; ``None`` re-reads
    the environment on the next call."""
    global _mode_override
    if mode is not None:
        mode = str(mode).lower()
        if mode not in _MODES:
            raise ValueError(f"verify mode must be one of {_MODES}")
    _mode_override = mode


FAMILIES = ("structural", "shapes", "collectives", "memory")

# check_before_compile result cache entries kept per Program (distinct
# (version, feeds, fetches, families) keys; stale versions evict in
# insertion order)
_VERIFY_CACHE_CAPACITY = 8


def verify_program(program, feed_names=(), fetch_names=(),
                   families=FAMILIES) -> Report:
    """Run the requested analysis families; return the full Report
    (no raising). Default: all four."""
    from .. import observability as _obs

    with _obs.timed("analysis.verify_latency"):
        report = Report()
        if "structural" in families:
            report.extend(
                analyze_structural(program, feed_names, fetch_names)
            )
        if "shapes" in families:
            report.extend(analyze_shapes(program))
        if "collectives" in families:
            report.extend(analyze_collectives(program))
        if "memory" in families:
            report.extend(
                analyze_memory(program, feed_names, fetch_names)
            )
    _obs.add("analysis.programs_verified")
    for sev, bucket in (
        (Severity.ERROR, "error"),
        (Severity.WARNING, "warning"),
        (Severity.INFO, "info"),
    ):
        n = sum(1 for f in report.findings if f.severity == sev)
        if n:
            _obs.add(f"analysis.findings.{bucket}", n)
    return report


def check_before_compile(program, feed_names=(), fetch_names=()):
    """The executor's hook where it builds a plan: verify once per
    program version and enforce the active mode. Returns the Report (or
    None when off).

    warn mode runs the graph-walk families only (structural +
    collective-schedule + memory — O(ops) python, microseconds to low
    ms); the shape/dtype family replays ``infer_shapes`` per op, seconds
    on detection-sized programs, so before a run it rides only the
    opt-in strict mode. ``verify_program`` always runs all families.

    The pass is cached per (version, feeds, fetches, families) in a small
    bounded dict — a program run alternately with two feed/fetch sets
    (train loss + eval metric) verifies once per set, not once per
    plan."""
    mode = verify_mode()
    if mode == "off":
        return None
    families = (
        FAMILIES if mode == "strict"
        else ("structural", "collectives", "memory")
    )
    key = (
        program._version,
        tuple(sorted(feed_names or ())),
        tuple(fetch_names or ()),
        families,
    )
    cache = program.__dict__.get("_verify_cache")
    if not isinstance(cache, dict):
        cache = {}
        program.__dict__["_verify_cache"] = cache
    report = cache.get(key)
    if report is None:
        report = verify_program(
            program, feed_names, fetch_names, families=families
        )
        while len(cache) >= _VERIFY_CACHE_CAPACITY:
            cache.pop(next(iter(cache)))
        cache[key] = report

    if mode == "strict":
        strict = report.strict_errors()
        if strict:
            from ..errors import ProgramVerifyError

            first = strict[0]
            raise ProgramVerifyError(
                "program verification failed under PADDLE_TPU_VERIFY="
                "strict — refusing to run:\n"
                + "\n".join("  " + f.format() for f in strict),
                findings=report.findings,
                loc=first.loc,
                op=first.op_type,
            )
    elif report.errors or report.warnings:
        from ..errors import ProgramVerifyWarning

        warnings.warn(
            report.render(min_severity=Severity.WARNING),
            ProgramVerifyWarning,
            stacklevel=3,
        )
    return report
