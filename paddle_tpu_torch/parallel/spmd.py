"""SPMD execution of a Program over a Mesh (counterpart of
paddle_tpu/parallel/spmd.py).

The JAX package traces a block once under `jax.shard_map` over its mesh:
every device runs the same program on its shard, collective ops see the
mesh axis names, and XLA lays them onto ICI. Here every rank (one process
each) runs the block eagerly on its shard, and the collective ops run
over the process group of their axis (parallel/mesh.py).

Sharding metadata lives on the Program, in the JAX package's form:
`program._sharding` maps a variable name to a tuple of mesh-axis names
per leading dimension (None: that dim is replicated). Unlisted
variables are replicated. The executor (framework/executor.py) follows
the JAX package's single-process convention: a feed is the global
value, and each rank takes its slice along the dims its spec names; a
fetch of a sharded variable is all-gathered into the global value on
every rank, a replicated one is returned as it is. (The multi-process
convention, where each process feeds only its shard, comes with
distributed/launch.py: ROADMAP Queue 1.)
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from ..errors import InvalidArgumentError, UnimplementedError


def spec_for(program, name):
    """The sharding spec of variable `name`: a tuple of mesh-axis names
    (or None) per leading dim; () when replicated. Optimizer accumulators
    of the same shape inherit their parameter's spec, as in the JAX
    package (optimizer.py tags them with _accum_of)."""
    s = program._sharding.get(name)
    if s:
        return tuple(s)
    v = program.global_block._find_var_recursive(name)
    parent = getattr(v, "_accum_of", None)
    if parent is not None and parent != name:
        pv = program.global_block._find_var_recursive(parent)
        if pv is not None and tuple(v.shape or ()) == tuple(pv.shape or ()):
            return spec_for(program, parent)
    return ()


def shard_program(program, mesh, shardings=None, mode="shard_map",
                  manual_axes=None):
    """Attach a mesh and sharding annotations to a Program.

    shardings: {var_name: tuple_of_axis_names_per_dim}, e.g. a sequence-
    sharded [B, H, S, D] feed -> {"x": (None, None, "sp")}. mode
    "shard_map" (explicit collective ops, as the transpilers and the SP
    ops use) is the one the port runs; "gspmd" and "hybrid" (XLA's
    sharding propagation) are not ported (ROADMAP Queue 1), nor is
    manual_axes, the hybrid mode's set of manual axes."""
    if mode != "shard_map" or manual_axes is not None:
        raise UnimplementedError(
            f"shard_program(mode={mode!r}, manual_axes={manual_axes!r}): "
            "only mode='shard_map' without manual_axes is ported; gspmd and "
            "hybrid SPMD are in ROADMAP Queue 1 item 1")
    if shardings:
        for name, axes in shardings.items():
            unknown = {a for dim in axes if dim is not None
                       for a in ((dim,) if isinstance(dim, str) else dim)
                       if a not in mesh.axis_names}
            if unknown:
                raise InvalidArgumentError(
                    f"sharding of {name!r} names {sorted(unknown)}, not axes "
                    f"of the mesh {mesh.axis_names}")
        program._sharding = {**program._sharding,
                             **{k: tuple(v) for k, v in shardings.items()}}
    program._mesh = mesh
    program._bump()
    return program


def _dim_axes(entry):
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_slice(mesh, t, spec, name):
    """This rank's part of the global value t under `spec`: along each
    named dim, the block of the rank's (row-major) coordinate over the
    dim's axes."""
    for dim, entry in enumerate(spec):
        axes = _dim_axes(entry)
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coordinate(a)
        if t.shape[dim] % n:
            raise InvalidArgumentError(
                f"{name!r}: dim {dim} of {tuple(t.shape)} does not split "
                f"into {n} shards over {axes}")
        t = t.narrow(dim, idx * (t.shape[dim] // n), t.shape[dim] // n)
    return t.contiguous()


def gather_global(mesh, t, spec):
    """The global value of this rank's part t under `spec`, on every rank:
    all-gathers each named dim over its axes, innermost axis first."""
    for dim, entry in enumerate(spec):
        for a in reversed(_dim_axes(entry)):
            parts = [torch.empty_like(t) for _ in range(mesh.shape[a])]
            dist.all_gather(parts, t.contiguous(), group=mesh.group(a))
            t = torch.cat(parts, dim)
    return t
