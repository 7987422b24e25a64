"""Model persistence (counterpart of paddle_tpu/io.py; reference
python/paddle/fluid/io.py: save_params :372, save_persistables :597,
load_persistables :902, save_inference_model :1093,
load_inference_model :1303, fluid.save/load :1598/:1662).

The files are the JAX package's, so a checkpoint or an inference model
crosses between the two packages:

* save_params/save_persistables write one ``__params__.npz`` per
  directory beside a ``manifest.json`` (per-array CRC32, shape, dtype);
* save/load write ``<path>.pdparams`` (a pickled {"params": {name:
  ndarray}, "opt": {...}}), ``<path>.pdmodel`` (the pickled Program) and
  ``<path>.manifest.json``;
* save_inference_model writes ``__model__`` (the pickled {"program",
  "feed_names", "fetch_names"}) beside ``__params__.npz`` and its
  manifest.

Every file lands through write-to-temp + fsync + ``os.replace``, so a
crash leaves the old file or a stray ``*.tmp.*`` (swept by
sweep_stale_tmp), never a torn file under the real name; an optional
size estimate preflights the volume's free bytes. Load paths verify the
whole payload against its manifest before the first scope write and
raise CheckpointCorruptionError on any mismatch or undecodable file.

Programs are written by `ProgramPickler` as the JAX package's IR classes
with its fields, so the JAX package reads the port's `.pdmodel` and
`__model__` (a program with a mesh is refused by name: its process groups
cannot be written). They are read back through `ProgramUnpickler`, which
maps the JAX package's IR classes to the port's, translating their
pickled fields on the way, and refuses every other global of paddle_tpu
and all of jax: reading a file never imports either (a parameter's
L2Decay or L1Decay becomes the port's class of that name). A program that
needs what the port lacks (a mesh, ZeRO shards, a pipeline) is refused
there by name.

Tensors leave the device as numpy arrays; bfloat16, which numpy lacks,
is written as float32 (exact) and read back in the dtype the program
declares. Arrays are placed on the executor's device, or the default
place (the card) when none is given.
"""

from __future__ import annotations

import copyreg
import errno as _errno
import json
import os
import pickle
import random as _random
import tempfile
import zlib

import numpy as np
import torch

from .convert import state_from_numpy
from .core.place import default_place
from .errors import (
    CheckpointCorruptionError,
    InvalidArgumentError,
    StorageExhaustedError,
    UnimplementedError,
)
from .framework.program import (
    Block,
    Operator,
    Parameter,
    Program,
    Variable,
    default_main_program,
)
from .framework.scope import global_scope
from .regularizer import L1Decay, L2Decay

__all__ = [
    "save_params",
    "save_persistables",
    "load_params",
    "load_persistables",
    "save",
    "load",
    "load_program",
    "save_inference_model",
    "load_inference_model",
    "prune",
    "verify_checkpoint_dir",
    "save_arrays",
    "read_persistables",
    "apply_persistables",
    "sweep_stale_tmp",
    "ProgramPickler",
    "ProgramUnpickler",
]

MANIFEST_NAME = "manifest.json"

#: ``PADDLE_TPU_STORAGE_PREFLIGHT=0`` turns the free-space check off; the
#: slack keeps a near-full volume from being filled to its last byte
PREFLIGHT_ENV = "PADDLE_TPU_STORAGE_PREFLIGHT"
PREFLIGHT_SLACK_ENV = "PADDLE_TPU_STORAGE_PREFLIGHT_SLACK"
_DEFAULT_PREFLIGHT_SLACK = 1 << 20  # 1 MiB


# -- durable writes -----------------------------------------------------------
def _fsync_dir(path):
    """Best-effort directory fsync, so the rename itself is durable."""
    try:
        fd = os.open(path or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def _free_bytes(dirname):
    try:
        st = os.statvfs(dirname)
    except (OSError, AttributeError):
        return None
    return st.f_bavail * st.f_frsize


def _storage_preflight(dirname, estimated_size):
    if os.environ.get(PREFLIGHT_ENV, "1").lower() in ("0", "false", "off"):
        return
    free = _free_bytes(dirname)
    if free is None:
        return
    try:
        slack = int(os.environ.get(PREFLIGHT_SLACK_ENV,
                                   _DEFAULT_PREFLIGHT_SLACK))
    except ValueError:
        slack = _DEFAULT_PREFLIGHT_SLACK
    if int(estimated_size) + slack > free:
        raise StorageExhaustedError(
            f"durable write into {dirname!r} refused by preflight: "
            f"~{int(estimated_size)} byte payload (+{slack} slack) vs "
            f"{free} free bytes; free space and retry"
        )


def _map_storage_error(exc, path):
    """ENOSPC/EDQUOT -> StorageExhaustedError; None for anything else."""
    if isinstance(exc, OSError) and not isinstance(
            exc, StorageExhaustedError) and exc.errno in (
            _errno.ENOSPC, getattr(_errno, "EDQUOT", _errno.ENOSPC)):
        return StorageExhaustedError(
            f"durable write of {path!r} hit "
            f"{_errno.errorcode.get(exc.errno, exc.errno)}: {exc}; "
            "retry once space is freed"
        )
    return None


def _atomic_write(path, write_fn, estimated_size=None):
    """Run write_fn(file) against a temp file in path's directory, fsync
    it and publish it with os.replace. With estimated_size, preflight the
    volume's free bytes first; ENOSPC/EDQUOT mid-write surfaces as
    StorageExhaustedError, the temp file already unlinked."""
    dirname = os.path.dirname(os.path.abspath(path))
    if estimated_size is not None:
        _storage_preflight(dirname, estimated_size)
    fd, tmp = tempfile.mkstemp(dir=dirname,
                               prefix=os.path.basename(path) + ".tmp.")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
        _fsync_dir(dirname)
    except BaseException as e:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        mapped = _map_storage_error(e, path)
        if mapped is not None:
            raise mapped from e
        raise


def sweep_stale_tmp(dirname):
    """Unlink the ``*.tmp.*`` residue of crashed writers in `dirname` (run
    it before writing there again). Returns the bytes reclaimed; never
    raises."""
    freed = 0
    try:
        names = os.listdir(dirname)
    except OSError:
        return 0
    for name in names:
        if ".tmp." not in name:
            continue
        p = os.path.join(dirname, name)
        try:
            size = os.path.getsize(p)
            os.unlink(p)
            freed += size
        except OSError:
            continue
    return freed


# -- manifests ----------------------------------------------------------------
def _array_entry(arr):
    a = np.asarray(arr)
    return {
        "crc32": zlib.crc32(np.ascontiguousarray(a).tobytes()) & 0xFFFFFFFF,
        "shape": list(a.shape),
        "dtype": str(a.dtype),
    }


def _write_manifest(path, payload_file, arrays):
    manifest = {
        "format": 1,
        "file": os.path.basename(payload_file),
        "arrays": {name: _array_entry(a) for name, a in arrays.items()},
    }
    _atomic_write(path,
                  lambda f: f.write(json.dumps(manifest, indent=1).encode()))


def _read_manifest(path):
    """The manifest dict, or None when there is none (an older file)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            return json.loads(f.read().decode())
    except (OSError, ValueError) as e:
        raise CheckpointCorruptionError(
            f"unreadable checkpoint manifest {path!r}: {e}") from e


def _verify_arrays(arrays, manifest, origin):
    if manifest is None:
        return
    want = manifest.get("arrays", {})
    missing = sorted(set(want) - set(arrays))
    if missing:
        raise CheckpointCorruptionError(
            f"checkpoint {origin!r} is missing arrays {missing} listed in "
            "its manifest")
    for name, entry in want.items():
        got = _array_entry(arrays[name])
        for field in ("shape", "dtype", "crc32"):
            if got[field] != entry[field]:
                raise CheckpointCorruptionError(
                    f"checkpoint {origin!r} array {name!r}: {field} "
                    f"mismatch (manifest {entry[field]!r}, file "
                    f"{got[field]!r})")


def _load_npz_verified(path, manifest_path=None):
    """Every array of an .npz, verified against the sibling manifest; any
    corruption raises CheckpointCorruptionError and nothing is returned
    in part."""
    manifest = _read_manifest(
        manifest_path if manifest_path is not None
        else os.path.join(os.path.dirname(path), MANIFEST_NAME))
    if manifest is not None and manifest.get("file") != os.path.basename(
            path):
        # the directory's manifest describes another payload of it
        manifest = None
    try:
        with np.load(path, allow_pickle=False) as data:
            arrays = {name: data[name] for name in data.files}
    except FileNotFoundError:
        if manifest is not None:
            raise CheckpointCorruptionError(
                f"checkpoint payload {path!r} is missing but its manifest "
                "exists (torn publish)") from None
        raise
    except Exception as e:  # zipfile.BadZipFile, zlib.error, OSError, ...
        raise CheckpointCorruptionError(
            f"undecodable checkpoint payload {path!r}: {e}") from e
    _verify_arrays(arrays, manifest, path)
    return arrays


def verify_checkpoint_dir(dirname, filename=None):
    """Read back a persistables directory and verify every array against
    its manifest, touching no scope; raises CheckpointCorruptionError."""
    _load_npz_verified(os.path.join(dirname, filename or "__params__.npz"))


# -- programs -----------------------------------------------------------------
# A `.pdmodel` or `__model__` of the JAX package pickles its Program, Block,
# Operator, Variable and Parameter objects. The unpickler builds each as a
# subclass of the port's class whose __setstate__ translates the JAX
# package's fields and then makes the object an instance of the port's
# class itself: what the port runs is kept, what only the TPU build uses is
# dropped when it holds its neutral value, and a program that needs what
# the port lacks (a mesh, ZeRO shards, a pipeline) is refused by name. A
# parameter's regularizer (the JAX package's L2Decay or L1Decay) becomes
# the port's class of that name. The port's own files and its copies
# (Program.clone) never pass through the translation.


def _unset(value):
    return value in (None, (), [], {}, False)


def _restore(obj, state, keep, defaults=None, optional=(), dropped=(),
             neutral=None):
    """Set obj's fields from a pickled `state`: each of `keep` (required),
    each of `defaults` (or its default), each of `optional` that the
    state holds, nothing of `dropped`; a field of `neutral` is dropped
    when its value passes the check, and refused otherwise; any other
    field is refused."""
    kind = type(obj).__name__
    defaults = defaults or {}
    neutral = neutral or {}
    unknown = sorted(set(state) - set(keep) - set(defaults) - set(optional)
                     - set(dropped) - set(neutral))
    if unknown:
        raise UnimplementedError(
            f"a pickled {kind} carries {unknown}, which the port has no "
            "counterpart for"
        )
    for key, ok in neutral.items():
        if key in state and not ok(state[key]):
            raise UnimplementedError(
                f"a pickled {kind} sets {key}={state[key]!r}, which the "
                "port does not run yet (a mesh and ZeRO shards: ROADMAP "
                "Queue 1, item 1 — data-parallel distribution; a pipeline: "
                "item 7 — model parallelism)"
            )
    missing = [k for k in keep if k not in state]
    if missing:
        raise InvalidArgumentError(
            f"a pickled {kind} lacks the fields {missing}"
        )
    for k in keep:
        setattr(obj, k, state[k])
    for k, default in defaults.items():
        setattr(obj, k, state[k] if k in state else default())
    for k in optional:
        if k in state:
            setattr(obj, k, state[k])


_VAR_FIELDS = ("block", "name", "shape", "dtype", "persistable",
               "stop_gradient", "is_data", "lod_level")
# the build-time initializer: nothing the port reads
_VAR_DROPPED = ("initializer",)
# an optimizer accumulator's tags (optimizer.py), kept where a file has them
_VAR_OPTIONAL = ("_accum_of", "_accum_elementwise")
# a layer's parameter: its ParamAttr's learning rate, kept and read by no
# optimizer, as in the JAX package (layers/helper.py)
_PARAM_OPTIONAL = _VAR_OPTIONAL + ("optimize_attr",)

# each IR class of the JAX package: how its pickled fields become the port's
_JAX_FIELDS = {
    Variable: dict(keep=_VAR_FIELDS, dropped=_VAR_DROPPED,
                   optional=_VAR_OPTIONAL,
                   neutral={"_zero_shard_of": _unset}),
    Parameter: dict(
        keep=_VAR_FIELDS + ("trainable",),
        defaults={"regularizer": lambda: None},
        dropped=_VAR_DROPPED + ("need_clip",), optional=_PARAM_OPTIONAL,
        neutral={"_zero_shard_of": _unset}),
    Operator: dict(keep=("block", "type", "inputs", "outputs", "attrs",
                         "uid")),
    Block: dict(keep=("program", "idx", "parent_idx", "vars", "ops")),
    Program: dict(
        keep=("blocks", "current_block_idx", "random_seed", "_version",
              "_op_uid"),
        defaults={
            # fields a file may predate get the JAX package's defaults
            "_rng_step": lambda: 0,
            "_rng_nonce": lambda: _random.SystemRandom().getrandbits(31) | 1,
            "_is_inference": lambda: False,
        },
        # set by the learning-rate schedulers of a program that has one
        optional=("_lr_counter_begin",),
        # the JAX package's SPMD mode, process-wide program ordinal and
        # caches: no meaning without a mesh or XLA
        dropped=("_spmd_mode", "_creation_ordinal",
                 "_structural_seed_cache", "_verify_cache"),
        neutral={k: _unset for k in (
            "_mesh", "_sharding", "_pipeline", "_manual_axes",
            "_zero_shard_vars", "_zero_quant", "_overlap_schedule")}),
}


def _translating(cls, rules):
    """The class the unpickler builds a JAX-package `cls` object as."""
    def __setstate__(self, state):
        _restore(self, state, **rules)
        self.__class__ = cls

    return type(cls.__name__, (cls,), {"__setstate__": __setstate__})


_FROM_JAX = {cls.__name__: _translating(cls, rules)
             for cls, rules in _JAX_FIELDS.items()}
_PORT_IR = {cls.__name__: cls for cls in _JAX_FIELDS}
# a parameter's regularizer, pickled (both ways) as the JAX package's class
# of that name with its one field, coeff
_JAX_REGULARIZER_MODULE = "paddle_tpu.regularizer"
_REGULARIZERS = {cls.__name__: cls for cls in (L2Decay, L1Decay)}
# what else a model or checkpoint file may name: numpy arrays and dtypes
_PLAIN_MODULES = ("numpy", "builtins", "collections", "copyreg", "_codecs")


class ProgramUnpickler(pickle.Unpickler):
    """Reads a pickled Program, model meta or checkpoint payload of either
    package: paddle_tpu's Program, Block, Operator, Variable and Parameter
    become the port's classes, their fields translated; the port's own
    load as they were written; numpy's globals load as usual; any other
    global, of paddle_tpu, jax or elsewhere, is refused and never
    imported."""

    def find_class(self, module, name):
        top = module.split(".")[0]
        if module == "paddle_tpu.framework.program" and name in _FROM_JAX:
            return _FROM_JAX[name]
        if module == "paddle_tpu_torch.framework.program" and name in _PORT_IR:
            return _PORT_IR[name]
        if module == _JAX_REGULARIZER_MODULE and name in _REGULARIZERS:
            return _REGULARIZERS[name]
        if top in ("jax", "jaxlib"):
            raise UnimplementedError(
                f"the file refers to {module}.{name}, a JAX object; the "
                "port reads no JAX state (save arrays as numpy)")
        if top in _PLAIN_MODULES:
            return super().find_class(module, name)
        raise UnimplementedError(
            f"the file refers to {module}.{name}, which the port does not "
            "read (only the IR classes and numpy arrays)")


# -- writing programs in the JAX package's form ------------------------------
# The port writes its IR objects as the JAX package's classes
# (paddle_tpu.framework.program.*) with the JAX package's fields, so the
# JAX package reads a `.pdmodel` or `__model__` the port wrote: the inverse
# of the translation above. The C pickler checks that a global it names can
# be imported, which paddle_tpu (and jax with it) must not be here, so the
# pure-Python pickler writes those globals itself.
_JAX_PROGRAM_MODULE = "paddle_tpu.framework.program"


class _JaxClass:
    """Stands for the JAX package's class `module.name` in a pickle
    stream."""

    def __init__(self, name, module=_JAX_PROGRAM_MODULE):
        self.name = name
        self.module = module


_TO_JAX = {cls: _JaxClass(cls.__name__) for cls in _JAX_FIELDS}
_TO_JAX.update({cls: _JaxClass(name, _JAX_REGULARIZER_MODULE)
                for name, cls in _REGULARIZERS.items()})


def _jax_fields(obj):
    """obj's pickled state in the JAX package's form: the port's fields
    plus what the JAX package's class carries beside them (at the
    neutral values the translation drops)."""
    state = dict(obj.__dict__)
    if isinstance(obj, Program):
        state.pop("_verify_cache", None)  # the verifier's reports
        if state.get("_mesh") is not None or state.get("_sharding"):
            raise UnimplementedError(
                "a program with a mesh (_mesh, _sharding: shard_program) "
                "holds process groups and cannot be written; save the "
                "program before shard_program, or a clone without them")
        state.update(_mesh=None, _sharding={}, _pipeline=None,
                     _spmd_mode="shard_map")
    elif isinstance(obj, Variable):
        state.setdefault("initializer", None)
        if isinstance(obj, Parameter):
            state.setdefault("regularizer", None)
            state.setdefault("need_clip", True)
    return state


class ProgramPickler(pickle._Pickler):
    """Writes a Program, model meta or checkpoint payload with the port's
    Program, Block, Operator, Variable, Parameter and regularizers as the
    JAX package's (their fields as the JAX package pickles them);
    everything else as pickle does. A program with a mesh is refused by
    name."""

    dispatch = dict(pickle._Pickler.dispatch)

    def reducer_override(self, obj):
        jax_cls = _TO_JAX.get(type(obj))
        if jax_cls is None:
            return NotImplemented
        # object.__new__ of the class, then its state (the JAX package's
        # Program.__setstate__, or __dict__ for the others)
        return copyreg._reconstructor, (jax_cls, object, None), \
            _jax_fields(obj)

    def _save_jax_class(self, obj):
        self.save(obj.module)
        self.save(obj.name)
        self.write(pickle.STACK_GLOBAL)
        self.memoize(obj)

    dispatch[_JaxClass] = _save_jax_class


def _dump(obj, f):
    ProgramPickler(f, protocol=4).dump(obj)


def _unpickle(path, what):
    try:
        with open(path, "rb") as f:
            return ProgramUnpickler(f).load()
    except FileNotFoundError:
        raise
    except UnimplementedError:
        raise
    except Exception as e:  # truncated or garbled: EOFError, Unpickling..
        raise CheckpointCorruptionError(
            f"undecodable {what} {path!r}: {e}") from e


def load_program(model_path):
    """The Program that save() wrote to ``<model_path>.pdmodel`` (by
    either package), with its random seed state."""
    return _unpickle(model_path + ".pdmodel", "program")


# -- scope <-> host arrays ----------------------------------------------------
def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()  # numpy has no bfloat16; the widening is exact
    return t.cpu().numpy()


def _collect(program, scope, predicate):
    """{name: host ndarray} of the scope's values of program's variables
    that satisfy `predicate`."""
    out = {}
    for var in program.list_vars():
        if not predicate(var):
            continue
        val = scope.find_var(var.name)
        if val is not None:
            out[var.name] = _host(val)
    return out


def _is_persistable(v):
    return bool(getattr(v, "persistable", False)) and not getattr(
        v, "is_data", False)


def _is_parameter(v):
    return isinstance(v, Parameter)


def _place(executor):
    return executor.place if executor is not None else default_place()


def save_params(executor, dirname, main_program=None, filename=None):
    _save_vars(dirname, main_program, _is_parameter, filename)


def save_persistables(executor, dirname, main_program=None, filename=None):
    _save_vars(dirname, main_program, _is_persistable, filename)


def _save_vars(dirname, main_program, predicate, filename):
    program = main_program or default_main_program()
    arrays = _collect(program, global_scope(), predicate)
    save_arrays(dirname, arrays, filename=filename)


def save_arrays(dirname, arrays, filename=None):
    """Write host arrays as a durable manifested directory (np.savez; the
    manifest's CRCs cover the raw bytes). Returns the payload's path."""
    os.makedirs(dirname, exist_ok=True)
    path = os.path.join(dirname, filename or "__params__.npz")
    est = sum(int(np.asarray(a).nbytes) for a in arrays.values())
    est += 1024 * (len(arrays) + 1)
    _atomic_write(path, lambda f: np.savez(f, **arrays), estimated_size=est)
    _write_manifest(os.path.join(dirname, MANIFEST_NAME), path, arrays)
    return path


def read_persistables(dirname, filename=None):
    """Verified host arrays of a persistables directory; no scope write."""
    return _load_npz_verified(
        os.path.join(dirname, filename or "__params__.npz"))


def apply_persistables(arrays, main_program=None, place=None):
    """Write verified host arrays into the current scope on `place` (the
    default place when None), each in the dtype main_program declares. A
    program with ZeRO shards never reaches here: its file is refused when
    read."""
    program = main_program or default_main_program()
    state_from_numpy(arrays, global_scope(), place, program=program)


def load_params(executor, dirname, main_program=None, filename=None):
    _load_vars(executor, dirname, main_program, filename)


def load_persistables(executor, dirname, main_program=None, filename=None):
    _load_vars(executor, dirname, main_program, filename)


def _load_vars(executor, dirname, main_program, filename):
    # the whole payload is verified before the first scope write
    arrays = read_persistables(dirname, filename)
    apply_persistables(arrays, main_program, place=_place(executor))


def save(program, model_path):
    """fluid.save: every persistable (parameters and optimizer state) in
    one payload, and the program, each file published atomically."""
    scope = global_scope()
    payload = {
        "params": _collect(program, scope, _is_parameter),
        "opt": _collect(program, scope,
                        lambda v: _is_persistable(v) and not _is_parameter(v)),
    }
    os.makedirs(os.path.dirname(model_path) or ".", exist_ok=True)
    est = sum(a.nbytes for g in payload.values() for a in g.values())
    _atomic_write(model_path + ".pdparams",
                  lambda f: pickle.dump(payload, f, protocol=4),
                  estimated_size=est + (1 << 16))
    _atomic_write(model_path + ".pdmodel", lambda f: _dump(program, f))
    _write_manifest(
        model_path + ".manifest.json", model_path + ".pdparams",
        {**{f"params/{k}": v for k, v in payload["params"].items()},
         **{f"opt/{k}": v for k, v in payload["opt"].items()}})


def load(program, model_path, var_list=None, executor=None):
    """fluid.load: the payload of save() into the scope, on the
    executor's device (the default place without one), in the dtypes
    `program` declares. Verified against its manifest before any scope
    write. With var_list, only those variables."""
    path = model_path + ".pdparams"
    manifest = _read_manifest(model_path + ".manifest.json")
    try:
        payload = _unpickle(path, "checkpoint payload")
    except FileNotFoundError:
        if manifest is not None:
            raise CheckpointCorruptionError(
                f"checkpoint payload {path!r} is missing but its manifest "
                "exists (torn publish)") from None
        raise
    flat = {f"{group}/{name}": arr
            for group in ("params", "opt")
            for name, arr in payload.get(group, {}).items()}
    _verify_arrays(flat, manifest, path)
    wanted = {v.name for v in var_list} if var_list else None
    arrays = {name: arr
              for group in ("params", "opt")
              for name, arr in payload.get(group, {}).items()
              if wanted is None or name in wanted}
    apply_persistables(arrays, program, place=_place(executor))


def prune(program, targets, feeds=()):
    """Backward-slice the program to the ops needed for `targets`. The
    slice stops at feed variables: their producers are replaced by the
    runtime feed."""
    target_names = {t.name if hasattr(t, "name") else str(t) for t in targets}
    feed_names = set(feeds)
    block = program.global_block
    needed = set(target_names)
    keep = []
    for op in reversed(block.ops):
        outs = [n for n in op.output_names() if n]
        if any(n in needed for n in outs):
            # an op whose only outputs are feeds exists to produce the
            # feed; the caller supplies it, so cut it out
            if outs and all(n in feed_names for n in outs):
                continue
            keep.append(op)
            needed.update(
                n for n in op.input_names() if n and n not in feed_names
            )
    keep_ids = {id(op) for op in keep}

    pruned = program.clone()
    pblock = pruned.global_block
    # ops were deep-copied by clone(); map them by position
    pblock.ops = [
        pop for op, pop in zip(block.ops, pblock.ops) if id(op) in keep_ids
    ]
    pruned._bump()
    return pruned


def save_inference_model(dirname, feeded_var_names, target_vars,
                         executor=None, main_program=None,
                         model_filename=None, params_filename=None):
    """The feed -> fetch slice of a test-mode clone, written as
    ``__model__`` and ``__params__.npz`` (+ manifest). The payload holds
    the persistables the slice reads (the JAX package writes every
    persistable of the program, optimizer moments included; both load
    either). Returns the fetch names."""
    program = main_program or default_main_program()
    test_prog = program.clone(for_test=True)
    targets = [
        test_prog.global_block.var(v.name if hasattr(v, "name") else str(v))
        for v in target_vars
    ]
    pruned = prune(test_prog, targets, feeds=feeded_var_names)
    pruned._is_inference = True
    os.makedirs(dirname, exist_ok=True)
    meta = {
        "program": pruned,
        "feed_names": list(feeded_var_names),
        "fetch_names": [t.name for t in targets],
    }
    _atomic_write(os.path.join(dirname, model_filename or "__model__"),
                  lambda f: _dump(meta, f))
    read = {n for op in pruned.global_block.ops for n in op.input_names()}
    arrays = _collect(pruned, global_scope(),
                      lambda v: _is_persistable(v) and v.name in read)
    save_arrays(dirname, arrays, filename=params_filename or "__params__.npz")
    return [t.name for t in targets]


def load_inference_model(dirname, executor=None, model_filename=None,
                         params_filename=None):
    """(program, feed_names, fetch_names) of an inference model written by
    either package; its parameters land in the current scope on the
    executor's device (the default place without one). The program runs
    in test mode (_is_inference)."""
    meta = _unpickle(os.path.join(dirname, model_filename or "__model__"),
                     "inference model")
    arrays = _load_npz_verified(
        os.path.join(dirname, params_filename or "__params__.npz"))
    program = meta["program"]
    apply_persistables(arrays, program, place=_place(executor))
    program._is_inference = True
    return program, meta["feed_names"], meta["fetch_names"]
