"""Port parity for the sequence-parallel training program at sp=1 and
without a mesh: a 1-rank gloo mesh in the test's process runs the ring at
n=1 (offsets 0, the collectives over the 1-rank group) against the JAX
package's sp=1 mesh; without a mesh the ops compute dense attention and
the collectives are the identity, against the JAX package's meshless
run. The method, shapes and tolerances are test_torch_sp_training.py's.
"""

import pytest

from test_torch_sp_training import _check, _jax_run, _jnp_backend  # noqa: F401
from test_torch_sp_training import _port_run


@pytest.mark.parametrize("world", [1, None], ids=["sp1", "meshless"])
def test_one_rank_and_meshless_runs_match_the_jax_package(world):
    start, want, end = _jax_run(world)
    got, loss_name = _port_run(world, start)
    _check(got, want, end, loss_name)


def test_mesh_and_shard_program_refuse_what_is_not_ported():
    """A mesh larger than the world raises and starts no group;
    shard_program refuses the gspmd and hybrid modes, manual_axes, and a
    sharding over an axis the mesh lacks, by name."""
    import torch.distributed as dist

    import paddle_tpu_torch as tf
    from paddle_tpu_torch.errors import InvalidArgumentError, UnimplementedError
    from paddle_tpu_torch.parallel import make_mesh, shard_program

    with pytest.raises(InvalidArgumentError, match="needs 2 ranks"):
        make_mesh({"sp": 2}, place=tf.CPUPlace())
    assert not dist.is_initialized()
    mesh = make_mesh({"sp": 1}, place=tf.CPUPlace())
    try:
        main = tf.Program()
        for kw in (dict(mode="gspmd"), dict(mode="hybrid"),
                   dict(manual_axes=("sp",))):
            with pytest.raises(UnimplementedError, match="shard_map"):
                shard_program(main, mesh, {"x": (None, "sp")}, **kw)
        assert main._mesh is None
        with pytest.raises(InvalidArgumentError, match="dp"):
            shard_program(main, mesh, {"x": ("dp",)})
        assert main._mesh is None and not main._sharding
    finally:
        mesh.close()
    assert not dist.is_initialized()
