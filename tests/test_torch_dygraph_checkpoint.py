"""save_dygraph / load_dygraph across the two packages: one file format
(a pickled dict of numpy arrays, protocol 4, at `<path>.pdparams`; a
`.pdopt` beside it is returned as the optimizer state). A net saved by
the JAX package loads into the port's net bit for bit and computes the
JAX package's output (atol 1e-5, fp32 sums in other orders); a net the
port saved (after an eager Adam step, so the values are its own) loads
into the JAX package's net bit for bit; the port's files read back in
the port too, and the port never imports jax to read them (checked in
a subprocess)."""

import pickle
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np

from paddle_tpu import dygraph as jdg

import paddle_tpu_torch as tf
from paddle_tpu_torch import dygraph as tdg

REPO = Path(__file__).resolve().parents[1]
X = np.random.RandomState(4).randn(3, 6).astype("float32")


def _net(dg):
    return dg.Sequential(dg.Linear(6, 8, act="relu"), dg.LayerNorm(8),
                         dg.Linear(8, 2))


def test_the_jax_packages_file_loads_into_the_port(tmp_path):
    path = str(tmp_path / "jax" / "model")
    with jdg.guard():
        jnet = _net(jdg)
        want = jnet(jdg.to_variable(X)).numpy()
        jdg.save_dygraph(jnet.state_dict(), path)
    with open(path + ".pdopt", "wb") as f:
        pickle.dump({"step": np.asarray(3)}, f, protocol=4)
    params, opt = tdg.load_dygraph(path)
    assert opt == {"step": 3}
    with tdg.guard(tf.CPUPlace()):
        net = _net(tdg)
        net.set_dict(params)
        for name, v in net.state_dict().items():
            np.testing.assert_array_equal(v, params[name], err_msg=name)
        got = net(tdg.to_variable(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_the_ports_file_loads_into_the_jax_package(tmp_path):
    path = str(tmp_path / "port" / "model")
    with tdg.guard(tf.CPUPlace()):
        net = _net(tdg)
        opt = tf.optimizer.Adam(0.01, parameter_list=net.parameters())
        loss = tf.layers.reduce_mean(net(tdg.to_variable(X)))
        loss.backward()
        opt.minimize(loss)
        state = net.state_dict()
        tdg.save_dygraph(state, path)
        want = net(tdg.to_variable(X)).numpy()
    with open(path + ".pdparams", "rb") as f:
        raw = pickle.load(f)
    assert all(type(v) is np.ndarray for v in raw.values())
    params, opt_state = jdg.load_dygraph(path)
    assert opt_state is None and set(params) == set(state)
    with jdg.guard():
        jnet = _net(jdg)
        jnet.set_dict(params)
        for name, v in jnet.state_dict().items():
            np.testing.assert_array_equal(v, state[name], err_msg=name)
        got = jnet(jdg.to_variable(X)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    mine, _ = tdg.load_dygraph(path)
    for name, v in state.items():
        np.testing.assert_array_equal(mine[name], v)


def test_reading_a_file_imports_neither_jax_nor_paddle_tpu(tmp_path):
    path = str(tmp_path / "m")
    with jdg.guard():
        jdg.save_dygraph(_net(jdg).state_dict(), path)
    code = textwrap.dedent(f"""
        import sys
        import paddle_tpu_torch as tf
        from paddle_tpu_torch import dygraph as dg
        params, _ = dg.load_dygraph({path!r})
        with dg.guard(tf.CPUPlace()):
            net = dg.Sequential(dg.Linear(6, 8, act="relu"),
                                dg.LayerNorm(8), dg.Linear(8, 2))
            net.set_dict(params)
        print(sorted(params) == sorted(net.state_dict()),
              [m for m in sys.modules if m == "jax" or m.startswith("jax.")
               or m == "paddle_tpu" or m.startswith("paddle_tpu.")])
    """)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "True []", out.stdout + out.stderr
