"""Program / Block / Operator / Variable — the static-graph IR (counterpart
of paddle_tpu/framework/program.py; reference framework.proto:42-216).

The IR is plain Python: an Operator names its input/output Variables per
slot, a Block is an ordered op list plus a var map, a Program a list of
Blocks. Every op type registers a torch emitter (registry.py) and the
Executor runs a block's ops in order. Shapes use -1 for the batch
dimension at build time; the feed tensors pin it at run time.
"""

from __future__ import annotations

import contextlib
import copy
import random as _random
from types import MappingProxyType

from ..core.dtypes import convert_dtype
from . import unique_name


class Variable:
    """Graph-time variable metadata. Runtime values live in a Scope."""

    def __init__(
        self,
        block,
        name,
        shape=None,
        dtype="float32",
        persistable=False,
        stop_gradient=False,
        is_data=False,
        lod_level=0,
    ):
        self.block = block
        self.name = name
        self.shape = tuple(int(s) for s in shape) if shape is not None else None
        self.dtype = convert_dtype(dtype)
        self.persistable = persistable
        self.stop_gradient = stop_gradient
        self.is_data = is_data
        self.lod_level = lod_level

    # fluid-style operator sugar: builds the ops the JAX package's
    # Variable builds (a float becomes a [1] fill_constant)
    def _elementwise(self, other, op_type, reverse=False):
        from .. import layers

        if not isinstance(other, Variable):
            other = layers.fill_constant([1], self.dtype, float(other))
        a, b = (other, self) if reverse else (self, other)
        return getattr(layers, op_type)(a, b)

    def __add__(self, other):
        return self._elementwise(other, "elementwise_add")

    __radd__ = __add__

    def __sub__(self, other):
        return self._elementwise(other, "elementwise_sub")

    def __rsub__(self, other):
        return self._elementwise(other, "elementwise_sub", reverse=True)

    def __mul__(self, other):
        return self._elementwise(other, "elementwise_mul")

    __rmul__ = __mul__

    def __truediv__(self, other):
        return self._elementwise(other, "elementwise_div")

    def __repr__(self):
        return (
            f"Variable(name={self.name!r}, shape={self.shape}, "
            f"dtype={self.dtype}, persistable={self.persistable})"
        )


class Parameter(Variable):
    """A trainable persistable variable (framework.py:4962 in the reference)."""

    def __init__(self, block, name, shape, dtype, trainable=True, **kw):
        kw.setdefault("persistable", True)
        kw.setdefault("stop_gradient", not trainable)
        super().__init__(block, name, shape=shape, dtype=dtype, **kw)
        self.trainable = trainable


GRAD_SUFFIX = "@GRAD"


def grad_var_name(name: str) -> str:
    return name + GRAD_SUFFIX


class Operator:
    """One op instance: type + named input/output slots + attrs.

    `__uid__` is a per-Program ordinal that survives clone(); the executor
    derives the op's random stream from it (registry.EmitContext.key_for),
    so two identically built programs draw identical streams."""

    def __init__(self, block, op_type, inputs=None, outputs=None, attrs=None):
        self.block = block
        self.type = op_type
        self.inputs = {k: list(v) for k, v in (inputs or {}).items()}
        self.outputs = {k: list(v) for k, v in (outputs or {}).items()}
        self.attrs = dict(attrs or {})
        self.uid = self.attrs.setdefault("__uid__", block.program._next_uid())

    def input_names(self):
        return [n for vs in self.inputs.values() for n in vs]

    def output_names(self):
        return [n for vs in self.outputs.values() for n in vs]

    def attr(self, name, default=None):
        return self.attrs.get(name, default)

    def __repr__(self):
        return f"Op({self.type}: {self.inputs} -> {self.outputs})"


class Block:
    def __init__(self, program, idx, parent_idx=-1):
        self.program = program
        self.idx = idx
        self.parent_idx = parent_idx
        self.vars = {}
        self.ops = []

    @property
    def parent_block(self):
        if self.parent_idx < 0:
            return None
        return self.program.blocks[self.parent_idx]

    def var(self, name):
        v = self._find_var_recursive(name)
        if v is None:
            from ..errors import NotFoundError

            raise NotFoundError(
                f"variable {name!r} not found in block {self.idx}"
            )
        return v

    def has_var(self, name):
        return self._find_var_recursive(name) is not None

    def _find_var_recursive(self, name):
        blk = self
        while blk is not None:
            if name in blk.vars:
                return blk.vars[name]
            blk = blk.parent_block
        return None

    def create_var(self, name=None, **kw):
        if name is None:
            name = unique_name.generate("tmp")
        v = Variable(self, name, **kw)
        self.vars[name] = v
        self.program._bump()
        return v

    def create_parameter(self, name, shape, dtype, **kw):
        p = Parameter(self, name, shape, dtype, **kw)
        self.vars[name] = p
        self.program._bump()
        return p

    def append_op(self, type, inputs=None, outputs=None, attrs=None,
                  index=None):
        """Append an op, or insert it before position `index` (the AMP
        rewrite inserts its casts in front of the op that reads them)."""
        op = Operator(self, type, inputs, outputs, attrs)
        if index is None:
            self.ops.append(op)
        else:
            self.ops.insert(index, op)
        self.program._bump()
        return op


class Program:
    # SPMD (parallel/spmd.py shard_program): the mesh and {var: spec};
    # class-level defaults, so programs read from files have them
    _mesh = None
    _sharding = MappingProxyType({})

    def __init__(self):
        self.blocks = [Block(self, 0)]
        self.current_block_idx = 0
        self.random_seed = 0
        self._version = 0
        self._op_uid = 0
        # per-program run counter folded into every random stream, so a
        # seeded program still draws new dropout masks each step
        self._rng_step = 0
        # fluid treats random_seed=0 as "nondeterministic": an unseeded
        # program draws its own nonce; clone() copies it
        self._rng_nonce = _random.SystemRandom().getrandbits(31) | 1
        # frozen serving programs set this: the executor then runs every
        # op in test mode (serving/freeze.py)
        self._is_inference = False

    def _next_uid(self):
        uid = self._op_uid
        self._op_uid += 1
        return uid

    def _bump(self):
        self._version += 1

    def estimate(self, feed_shapes=None, peak_tflops=None, peak_gbps=None):
        """Analytic per-op FLOPs / bytes / roofline-latency table for ONE
        step of this program (analysis/cost.py), with the static memory
        plan (``peak_bytes`` / ``resident_bytes`` / ``memory``:
        analysis/memory.py). `feed_shapes` ({var: shape}) pins -1 batch
        dims; the peaks default from ``PADDLE_TPU_PEAK_TFLOPS`` /
        ``PADDLE_TPU_PEAK_GBPS`` (the H100's). A walk over the declared
        Variable shapes: no emitter runs."""
        from ..analysis.cost import estimate_program

        return estimate_program(
            self, feed_shapes=feed_shapes, peak_tflops=peak_tflops,
            peak_gbps=peak_gbps,
        )

    @property
    def global_block(self):
        return self.blocks[0]

    def current_block(self):
        return self.blocks[self.current_block_idx]

    def list_vars(self):
        for b in self.blocks:
            yield from b.vars.values()

    def all_parameters(self):
        return [v for b in self.blocks for v in b.vars.values()
                if isinstance(v, Parameter)]

    def clone(self, for_test=False):
        """Deep copy. for_test=True flips is_test on the ops that carry it
        (dropout and the fused ops), matching fluid Program.clone."""
        # the mesh holds process groups: shared by the clone, never copied
        mesh, self._mesh = self._mesh, None
        try:
            p = copy.deepcopy(self)
        finally:
            self._mesh = mesh
        if mesh is not None:
            p._mesh = mesh
        if for_test:
            for b in p.blocks:
                for op in b.ops:
                    if "is_test" in op.attrs:
                        op.attrs["is_test"] = True
        p._bump()
        return p

    def __repr__(self):
        lines = []
        for b in self.blocks:
            lines.append(f"block {b.idx} (parent {b.parent_idx}):")
            for op in b.ops:
                lines.append(f"  {op}")
        return "\n".join(lines)


_main_program = Program()
_startup_program = Program()


def default_main_program() -> Program:
    return _main_program


def default_startup_program() -> Program:
    return _startup_program


@contextlib.contextmanager
def program_guard(main_program, startup_program=None):
    global _main_program, _startup_program
    old_main, old_startup = _main_program, _startup_program
    _main_program = main_program
    if startup_program is not None:
        _startup_program = startup_program
    try:
        yield
    finally:
        _main_program, _startup_program = old_main, old_startup


# --- dygraph mode switch (framework.py:180 in the reference): the eager
# tracer of a `dygraph.guard()`, or None in static mode ---
_dygraph_tracer = None


def in_dygraph_mode() -> bool:
    return _dygraph_tracer is not None


def _set_dygraph_tracer(tracer):
    global _dygraph_tracer
    _dygraph_tracer = tracer


def _current_tracer():
    return _dygraph_tracer
