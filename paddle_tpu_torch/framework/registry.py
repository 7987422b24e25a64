"""Op registry: every op type is a torch *emitter* (counterpart of
paddle_tpu/framework/registry.py).

An emitter is `fn(ctx, op, ins) -> {slot: [tensor]}` over torch tensors.
The Executor calls the emitters of a block in order. Shape inference
runs the same emitter on `device="meta"` tensors, which carry shape and
dtype but no storage, so one definition serves execution, shapes and
dtypes. A -1 (batch) dim is mapped through a prime sentinel while the
emitter runs.
"""

from __future__ import annotations

import hashlib
import itertools
import struct
import zlib

import torch

from ..core.dtypes import convert_dtype, to_torch_dtype

# prime sentinel standing in for the -1 (batch) dim during shape inference
BATCH_SENTINEL = 12289

_META = torch.device("meta")


class EmitContext:
    """Per-run state handed to emitters: the device, the mode flag, the
    random streams and, under SPMD, the mesh: `mesh_axes` (the axes
    collectives run over), `axis_sizes`, and per axis this rank's process
    group (`axis_group`) and coordinate (`axis_index`).

    RNG: every Operator owns a stable uid; the stream of op U at run S of
    a program seeded with `seed` is a torch.Generator seeded from
    (seed, S, U, crc32(op type)). The op-type salt keeps the startup and
    main programs of one seed from sharing streams. The fused kernels'
    keep masks take two seed words from the same digest (seed_words). A
    grad op replays its forward op under the forward's uid, so its
    dropout mask is the forward's."""

    def __init__(self, device, seed=0, step=0, is_test=False, abstract=False,
                 mesh=None, first_run=False):
        self.device = torch.device(device)
        self.seed = int(seed)
        self.step = int(step)
        self.is_test = is_test
        # True only in infer_shapes' meta-tensor pass: emitters may then
        # substitute BATCH_SENTINEL for -1 dims; at run time -1 is an error
        self.abstract = abstract
        # True on an executor's first run of a (program, version, feed
        # signature, fetch set): where the JAX package traces the block.
        # Trace-time counters (embedding.fused_lookup_*) count there
        self.first_run = first_run
        # the program's mesh (parallel/mesh.py) under SPMD, else None
        self.mesh = mesh
        self.mesh_axes = tuple(mesh.axis_names) if mesh is not None else ()
        self.axis_sizes = dict(mesh.shape) if mesh is not None else {}

    def axis_group(self, axis):
        """The process group of mesh axis `axis` this rank belongs to."""
        return self.mesh.group(axis)

    def axis_index(self, axis):
        """This rank's coordinate along mesh axis `axis`."""
        return self.mesh.coordinate(axis)

    def _digest(self, op_uid, op_type):
        salt = zlib.crc32(op_type.encode()) & 0x7FFFFFFF
        return hashlib.blake2b(
            struct.pack("<qqqq", self.seed, self.step, int(op_uid), salt),
            digest_size=8,
        ).digest()

    def key_for(self, op_uid: int, op_type: str = ""):
        """torch.Generator on this context's device for one op's draw
        (None while inferring shapes: meta tensors draw nothing)."""
        if self.abstract:
            return None
        digest = self._digest(op_uid, op_type)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int.from_bytes(digest, "little") & 0x7FFFFFFFFFFFFFFF)
        return gen

    def seed_words(self, op_uid: int, op_type: str = ""):
        """Two uint32 words for one op's Philox keep mask, from the same
        digest as key_for, made on the host (None while inferring
        shapes). A grad op passes its forward op's uid and type, so it
        regenerates the forward's mask."""
        if self.abstract:
            return None
        digest = self._digest(op_uid, op_type)
        return (int.from_bytes(digest[:4], "little"),
                int.from_bytes(digest[4:], "little"))


class OpView:
    """Stand-in for an Operator when a grad op replays its forward op's
    emitter: the same attrs, so the same `__uid__` and random stream.
    The eager tracer (dygraph/tracer.py) runs ops through it too, with
    `outputs` naming the output slots an emitter is asked for; the
    program analyses (analysis/) name its `inputs` as well."""

    def __init__(self, op_type, attrs, outputs=None, inputs=None):
        self.type = op_type
        self.attrs = dict(attrs or {})
        self.outputs = dict(outputs or {})
        self.inputs = dict(inputs or {})

    @property
    def uid(self):
        return self.attrs.get("__uid__", 0)

    def attr(self, name, default=None):
        return self.attrs.get(name, default)


class OpDef:
    def __init__(self, type, emit, input_slots, output_slots,
                 differentiable=True, grad_maker=None, mutates=()):
        self.type = type
        self.emit = emit  # fn(ctx, op, ins) -> outs (dict slot -> list)
        self.input_slots = tuple(input_slots)
        self.output_slots = tuple(output_slots)
        self.differentiable = differentiable
        # fn(op, block, contribs, finalize, needs_grad=) appending a
        # dedicated grad op; returning False declines, and the generic
        # __vjp__ replay (backward.py) takes the op instead
        self.grad_maker = grad_maker
        # (output slot, input slot) pairs whose output is the input's
        # tensor updated in place (kv_cache_write's Out is its Cache)
        self.mutates = tuple(mutates)


_REGISTRY: dict[str, OpDef] = {}


def register_op(type, inputs, outputs, **kw):
    """Decorator: @register_op("relu", inputs=["X"], outputs=["Out"])."""

    def deco(fn):
        _REGISTRY[type] = OpDef(type, fn, inputs, outputs, **kw)
        return fn

    return deco


def get_op_def(op_type: str) -> OpDef:
    if op_type not in _REGISTRY:
        from ..errors import UnimplementedError

        raise UnimplementedError(
            f"op type {op_type!r} is not registered"
        )
    return _REGISTRY[op_type]


# ---------------------------------------------------------------------------
# shape inference on meta tensors
# ---------------------------------------------------------------------------


def _meta_from_var(var):
    shape = []
    for s in var.shape or ():
        if s in (-1, None):
            shape.append(BATCH_SENTINEL)
        else:
            s = int(s)
            if s != 0 and s % BATCH_SENTINEL == 0:
                # a real dim that is a multiple of the sentinel would
                # round-trip to -1 in _shape_back; refuse instead
                raise ValueError(
                    f"variable {var.name!r} has dim {s}, a multiple of the "
                    f"internal batch sentinel {BATCH_SENTINEL}"
                )
            shape.append(s)
    return torch.empty(shape, dtype=to_torch_dtype(var.dtype), device=_META)


def _shape_back(shape):
    return tuple(
        -1 if (d != 0 and d % BATCH_SENTINEL == 0) else int(d) for d in shape
    )


def infer_shapes(op_type, block, inputs, attrs):
    """{slot: [(shape, dtype_name), ...]} for an op's outputs, from one run
    of its emitter on meta tensors. inputs: {slot: [var names]}."""
    from .program import Operator

    op_def = get_op_def(op_type)
    ins = {
        slot: [_meta_from_var(block.var(n)) if n else None for n in names]
        for slot, names in (inputs or {}).items()
    }
    fake_op = Operator(block, op_type, inputs, {}, attrs)
    ctx = EmitContext(_META, is_test=True, abstract=True)
    out = op_def.emit(ctx, fake_op, ins)
    return {
        slot: [
            (None, None) if v is None
            else (_shape_back(v.shape), convert_dtype(v.dtype))
            for v in vals
        ]
        for slot, vals in out.items()
    }


def run_op(ctx, op, env):
    """Execute one op's emitter against an env (name -> tensor)."""
    op_def = get_op_def(op.type)
    ins = {
        slot: [env[n] if n else None for n in names]
        for slot, names in op.inputs.items()
    }
    outs = op_def.emit(ctx, op, ins)
    for slot, names in op.outputs.items():
        vals = outs.get(slot, [])
        for n, v in itertools.zip_longest(names, vals):
            if n and v is not None:
                env[n] = v
    return outs
