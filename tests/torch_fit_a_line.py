"""The training-breadth parity tests' shared harness: one program built
in both packages from a fresh unique_name state (so their variable names
match), the JAX package's startup state carried into the port with
convert.state_from_numpy, both run on the CPU on the same numpy feeds,
and every fetch and the whole persistable state returned from each.

The default program is tests/test_optimizers_sweep.py's fit-a-line: an
fc of [16, 4] inputs to one output, the mean of its square_error_cost.

    from torch_fit_a_line import JAX, PORT, fit_a_line, run_both
"""

import numpy as np

import paddle_tpu as jf
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope

import paddle_tpu_torch as tf
from paddle_tpu_torch import convert

JAX = (jf, jun, JScope)
PORT = (tf, tf.unique_name, tf.Scope)


def build(pkg, body, seed=3):
    """body(fluid) under a fresh unique_name state in a new (main,
    startup) pair seeded `seed`; returns (main, startup, body's value)."""
    fluid, unique_name, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = seed
    with unique_name.guard(), fluid.program_guard(main, startup):
        out = body(fluid)
    return main, startup, out


def fit_a_line(make_opt, param_attr=None, bias_attr=None):
    """A body: fit-a-line minimized by make_opt(fluid); returns (loss,
    optimizer, params_grads)."""
    def body(fluid):
        x = fluid.data("x", [16, 4])
        y = fluid.data("y", [16, 1])
        pred = fluid.layers.fc(x, 1, param_attr=param_attr,
                               bias_attr=bias_attr)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
        opt = make_opt(fluid)
        _, pg = opt.minimize(loss)
        return loss, opt, pg

    return body


def line_feeds(n, seed=0):
    """n feeds of the sweep's target y = x @ [0, 1, 2, 3]."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xv = rng.randn(16, 4).astype(np.float32)
        yv = xv @ np.arange(4, dtype=np.float32).reshape(4, 1)
        out.append({"x": xv, "y": yv})
    return out


def op_attrs(op):
    """An op's attrs without the bookkeeping (uid, build site)."""
    return {k: v for k, v in op.attrs.items()
            if not k.startswith("__") and k != "fwd_attrs"}


def same_program(jmain, tmain):
    """The two main programs hold the same ops, slots and attrs."""
    jops, tops = jmain.global_block.ops, tmain.global_block.ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for jop, top in zip(jops, tops):
        assert top.inputs == jop.inputs and top.outputs == jop.outputs, top
        assert op_attrs(top) == op_attrs(jop), top.type


def jax_state(scope):
    return {n: np.asarray(scope.find_var(n)) for n in scope.local_var_names()}


def run_both(body, feeds, fetch=lambda out: [out[0]], seed=3, seed_port=None,
             check_program=True):
    """Builds body in both packages, runs one step per feed in each from
    the JAX package's startup state, fetching fetch(body's value) by
    name. Returns a dict: start (state), jax / port (fetches a step),
    jax_end / port_end (state), jax_out / port_out (body's values),
    jax_main / port_main."""
    jmain, jstartup, jout = build(JAX, body, seed)
    tmain, _, tout = build(PORT, body, seed if seed_port is None
                           else seed_port)
    if check_program:
        same_program(jmain, tmain)
    jscope, jexe = JScope(), jf.Executor(jf.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    start = jax_state(jscope)
    tscope, texe = tf.Scope(), tf.Executor(tf.CPUPlace())
    convert.state_from_numpy(start, tscope, tf.CPUPlace(), program=tmain)
    jnames = [v.name for v in fetch(jout)]
    tnames = [v.name for v in fetch(tout)]
    got, want = [], []
    for feed in feeds:
        want.append([np.asarray(v) for v in jexe.run(
            jmain, feed=feed, fetch_list=jnames, scope=jscope)])
        got.append(texe.run(tmain, feed=feed, fetch_list=tnames,
                            scope=tscope))
    return dict(start=start, jax=want, port=got, jax_end=jax_state(jscope),
                port_end=convert.state_to_numpy(tscope), jax_out=jout,
                port_out=tout, jax_main=jmain, port_main=tmain,
                jax_scope=jscope, port_scope=tscope)


def assert_states_close(got, want, rtol, atol, skip=()):
    """Every persistable of want, in got, within atol + rtol |want|;
    integers (counters) equal after a cast (the JAX package runs without
    64-bit types)."""
    assert set(got) == set(want)
    for name, w in want.items():
        if name in skip:
            continue
        g = got[name]
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g.astype(w.dtype), w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol,
                                       err_msg=name)


def run_op(pkg, op_type, inputs, outputs, attrs, seed=0):
    """One op appended by hand to a program of fed inputs: inputs {slot:
    [ndarray]} (fed as `<slot>_<i>`), outputs {slot: count}; returns
    {slot: [ndarray]} of the op's outputs on the CPU."""
    fluid, unique_name, _ = pkg
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = seed
    feed, ins = {}, {}
    with unique_name.guard(), fluid.program_guard(main, startup):
        blk = main.global_block
        for slot, arrays in inputs.items():
            ins[slot] = []
            for i, a in enumerate(arrays):
                name = f"{slot}_{i}"
                fluid.data(name, list(a.shape), str(a.dtype))
                feed[name] = a
                ins[slot].append(name)
        outs = {slot: [blk.create_var(name=f"{slot}_out_{i}").name
                       for i in range(k)] for slot, k in outputs.items()}
        blk.append_op(op_type, ins, outs, dict(attrs))
    names = [n for ns in outs.values() for n in ns]
    vals = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                fetch_list=names)
    it = iter(np.asarray(v) for v in vals)
    return {slot: [next(it) for _ in ns] for slot, ns in outs.items()}
