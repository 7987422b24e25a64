"""The embedding engine against the JAX package's: one cached Adam run
(DeepFM per-slot, fused, hot tier at half the vocab: misses, evictions,
write-backs of the tables and their moments) in both packages, the port
started from the JAX package's startup state. Both cold stores start
bit-equal (cache._replay_init is a numpy stream); after that the dense
tower's products round differently in the two packages. Tolerances from
readings: losses rtol 1e-6 (measured 8.6e-8), every flushed host store
rtol 1e-6 + atol 1e-7 (measured 3.0e-8 absolute).
"""

import numpy as np

import paddle_tpu as jf
from paddle_tpu.embedding import EmbeddingEngine as JEngine
from paddle_tpu.embedding import fuse_lookups as jfuse
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.scope import Scope as JScope
from paddle_tpu.models.deepfm import deepfm as jdeepfm

from paddle_tpu_torch import convert, observability

from test_torch_embedding_engine import CFG, CPU, _build_deepfm, _feeds, \
    _train
from torch_threads import one_cpu_thread  # noqa: F401 (autouse)


def test_cached_adam_matches_the_jax_packages_cached_run():
    """The same cached Adam run (hot tier vocab/2: evictions and
    write-backs of tables and moments) in both packages, the port
    started from the JAX package's startup state: both cold stores start
    bit-equal (the numpy replay), the losses and every flushed store
    agree within rtol 1e-6, atol 1e-7."""
    observability.reset()
    feeds = _feeds(6)
    hot = CFG.vocab_size // 2
    jpkg = (jf, jun, JScope, jdeepfm, jfuse, JEngine, jf.CPUPlace())
    jmain, _js, jscope, jexe, jloss, _jp, jengine = _build_deepfm(
        jpkg, per_slot=True, fused=True, hot_rows=hot, opt="adam")
    main, _s, scope, exe, loss, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=hot, opt="adam")
    # every accumulator of a cached table found by its _accum_of tag
    names = [{t: [a for a, _ in v] for t, v in e.groups[0].accums.items()}
             for e in (engine, jengine)]
    assert names[0] == names[1]
    assert len(engine.groups[0].accums["deepfm_emb"]) == 2
    for t in engine.groups[0].host:
        np.testing.assert_array_equal(engine.groups[0].host[t],
                                      jengine.groups[0].host[t])
    state = {n: np.asarray(jscope.find_var(n))
             for n in jscope.local_var_names()}
    convert.state_from_numpy(state, scope, CPU, program=main)
    want = _train(jmain, jscope, jexe, jloss, feeds, jengine)
    got = _train(main, scope, exe, loss, feeds, engine)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert observability.get_counters()["embedding.cache_evictions"] > 0
    jstate, tstate = jengine.state_dict(jscope), engine.state_dict(scope)
    assert set(tstate) == set(jstate)
    for k, w in jstate.items():
        np.testing.assert_allclose(tstate[k], np.asarray(w), rtol=1e-6,
                                   atol=1e-7, err_msg=k)
