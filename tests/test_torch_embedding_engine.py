"""The embedding engine of the port (paddle_tpu_torch/embedding): the
meshless cases of tests/test_embedding_engine.py, run on the port. The
cached Adam run against the JAX package's is in
test_torch_embedding_engine_jax.py.

The fused and cached paths are held BITWISE against the per-slot and
full-table baselines, as the JAX package's tests hold them; across
layouts the first step is bitwise and later ones within rtol 1e-5 (a
repeated id's row gradient sums in another order).
"""

import threading
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as fluid
from paddle_tpu_torch import layers, observability
from paddle_tpu_torch.embedding import (
    EmbeddingEngine,
    Prefetcher,
    fuse_lookups,
)
from paddle_tpu_torch.errors import (
    InvalidArgumentError,
    PreconditionNotMetError,
)
from paddle_tpu_torch.models import DeepFMConfig, deepfm

from torch_threads import one_cpu_thread  # noqa: F401 (autouse)

CFG = DeepFMConfig(vocab_size=256, num_fields=6, embed_dim=8,
                   mlp_sizes=(16,))
B = 16
CPU = fluid.CPUPlace()


@pytest.fixture(autouse=True)
def fresh_registry():
    observability.reset()
    yield


def _feeds(n, vocab=None, b=B, fields=None, seed=0):
    vocab = vocab or CFG.vocab_size
    fields = fields or CFG.num_fields
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        idv = (vocab * rng.power(0.4, (b, fields))).astype(np.int64)
        out.append({"feat_ids": idv,
                    "label": (idv[:, :1] % 2 == 0).astype(np.float32)})
    return out


def _build_deepfm(pkg=None, per_slot=False, fused=False, hot_rows=None,
                  opt="sgd", seed=3, cfg=CFG, b=B):
    """(main, startup, scope, exe, loss, pred, engine) of deepfm built and
    initialised by `pkg` (the port unless the JAX package's names are
    passed: fluid, unique_name, Scope, deepfm, fuse_lookups, engine,
    place)."""
    if pkg is None:
        pkg = (fluid, fluid.unique_name, fluid.Scope, deepfm, fuse_lookups,
               EmbeddingEngine, CPU)
    fl, unique_name, scope_cls, model, fuse, engine_cls, place = pkg
    main, startup = fl.Program(), fl.Program()
    main.random_seed = startup.random_seed = seed
    scope = scope_cls()
    with fl.program_guard(main, startup), fl.scope_guard(scope), \
            unique_name.guard():
        ids = fl.data("feat_ids", [b, cfg.num_fields], "int64")
        label = fl.data("label", [b, 1], "float32")
        loss, pred = model(ids, label, cfg, per_slot=per_slot)
        if fused:
            fuse(main)
        engine = None
        if hot_rows:
            engine = engine_cls(main, startup, hot_rows=hot_rows)
        optimizer = {
            "sgd": lambda: fl.optimizer.SGD(0.1),
            "momentum": lambda: fl.optimizer.Momentum(0.05, 0.9),
            "adam": lambda: fl.optimizer.Adam(0.01),
        }[opt]()
        optimizer.minimize(loss)
        exe = fl.Executor(place)
        exe.run(startup, scope=scope)
        if engine:
            engine.attach(scope)
    return main, startup, scope, exe, loss, pred, engine


def _train(main, scope, exe, loss, feeds, engine=None):
    losses = []
    for f in feeds:
        ff = engine.prepare_feed(f, scope) if engine else f
        (lv,) = exe.run(main, feed=ff, fetch_list=[loss], scope=scope)
        losses.append(float(np.asarray(lv).reshape(-1)[0]))
    return losses


def _pick(built):
    main, _startup, scope, exe, loss, _pred, _eng = built
    return main, scope, exe, loss


# ---------------------------------------------------------------------------
# fused multi-table lookup
# ---------------------------------------------------------------------------


def test_fuse_lookups_coalesces_per_slot_graph():
    main = _build_deepfm(per_slot=True, fused=True)[0]
    ops = main.global_block.ops
    assert not [op for op in ops if op.type == "distributed_lookup_table"]
    fused = [op for op in ops if op.type == "fused_lookup_table"]
    # one fused site per table width: [V, 1] (w1) and [V, D] (emb); every
    # slot reads the one shared table through slot_table_idx
    assert len(fused) == 2
    for op in fused:
        assert len(op.inputs["W"]) == 1
        assert op.attr("slot_table_idx") == [0] * CFG.num_fields
        assert len(op.inputs["Ids"]) == CFG.num_fields
        assert len(op.outputs["Out"]) == CFG.num_fields
    assert observability.get_counters()["embedding.fuse_transforms"] == 2


def test_fused_training_parity_across_layouts():
    """The first step is bitwise across the three layouts; later steps
    within rtol 1e-5 (one segment-sum against F partial sums)."""
    feeds = _feeds(5)
    ref = _train(*_pick(_build_deepfm(per_slot=False)), feeds)
    per_slot = _train(*_pick(_build_deepfm(per_slot=True)), feeds)
    fused = _train(*_pick(_build_deepfm(per_slot=True, fused=True)), feeds)
    assert ref[0] == per_slot[0] == fused[0]
    np.testing.assert_allclose(ref, per_slot, rtol=1e-5)
    np.testing.assert_allclose(per_slot, fused, rtol=1e-5)


def test_fused_forward_values_bitwise():
    """The fused gather returns exactly the per-slot gathers' rows."""
    b, f, v, d = 8, 4, 64, 8
    idv = np.random.RandomState(1).randint(0, v, (b, f)).astype(np.int64)
    outs = {}
    for fused in (False, True):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 5
        scope = fluid.Scope()
        with fluid.program_guard(main, startup), \
                fluid.scope_guard(scope), fluid.unique_name.guard():
            ids = fluid.data("ids", [b, f], "int64")
            parts = [layers.sparse_embedding(
                layers.slice(ids, [1], [i], [i + 1]), [v, d],
                param_attr=fluid.ParamAttr(name="tab")) for i in range(f)]
            if fused:
                assert fuse_lookups(main) == 1
            exe = fluid.Executor(CPU)
            exe.run(startup, scope=scope)
            outs[fused] = exe.run(main, feed={"ids": idv},
                                  fetch_list=list(parts), scope=scope)
    for a, b_ in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b_)


def test_fuse_respects_intermediate_readers():
    """A consumer between two lookups pins the first group."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.data("ids", [8, 1], "int64")
        a = layers.sparse_embedding(
            ids, [32, 4], param_attr=fluid.ParamAttr(name="t1"))
        consumed = layers.scale(a, scale=2.0)  # reads a before lookup 2
        b_ = layers.sparse_embedding(
            ids, [32, 4], param_attr=fluid.ParamAttr(name="t2"))
        _ = consumed + b_
    assert fuse_lookups(main) == 0
    assert all(op.type != "fused_lookup_table"
               for op in main.global_block.ops)


def test_fuse_groups_by_width_and_dtype():
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.data("ids", [8, 1], "int64")
        outs = [
            layers.sparse_embedding(
                ids, size, param_attr=fluid.ParamAttr(name=name))
            for name, size in (("a4", [32, 4]), ("a8", [32, 8]),
                               ("b4", [64, 4]), ("b8", [32, 8]))
        ]
        _ = layers.concat([layers.reshape(o, [8, -1]) for o in outs],
                          axis=1)
    assert fuse_lookups(main) == 2  # width-4 pair + width-8 pair
    fused = [op for op in main.global_block.ops
             if op.type == "fused_lookup_table"]
    widths = sorted(
        main.global_block.var(op.inputs["W"][0]).shape[1] for op in fused)
    assert widths == [4, 8]


def test_dedup_golden_parity_vs_legacy_path():
    """dedup=True is bitwise equal to the gather-per-occurrence path
    forward; its gradients and losses within rtol 1e-5 / 1e-6 (repeated
    rows summed in another order, and really summed)."""
    b, v, d = 32, 16, 4  # 32 ids over 16 rows: guaranteed repeats
    idv = np.random.RandomState(0).randint(0, v, b).astype(np.int64)
    runs = {}
    for dedup in (False, True):
        main, startup = fluid.Program(), fluid.Program()
        main.random_seed = startup.random_seed = 2
        scope = fluid.Scope()
        with fluid.program_guard(main, startup), \
                fluid.scope_guard(scope), fluid.unique_name.guard():
            ids = fluid.data("ids", [b], "int64")
            out = layers.sparse_embedding(
                ids, [v, d], param_attr=fluid.ParamAttr(name="table"),
                dedup=dedup)
            loss = layers.reduce_sum(layers.square(out))
            fluid.optimizer.SGD(0.05).minimize(loss)
            exe = fluid.Executor(CPU)
            exe.run(startup, scope=scope)
            (fwd,) = exe.run(main, feed={"ids": idv}, fetch_list=[out],
                             scope=scope)
            losses = _train(main, scope, exe, loss, [{"ids": idv}] * 4)
            (g,) = exe.run(main, feed={"ids": idv},
                           fetch_list=["table@GRAD"], scope=scope)
        runs[dedup] = (fwd, losses, g)
    np.testing.assert_array_equal(runs[False][0], runs[True][0])
    np.testing.assert_allclose(runs[False][2], runs[True][2], rtol=1e-5)
    np.testing.assert_allclose(runs[False][1], runs[True][1], rtol=1e-6)


# ---------------------------------------------------------------------------
# cache tier: capacity, eviction/refetch, checkpoint
# ---------------------------------------------------------------------------


def test_cached_training_bitwise_vs_full_table():
    """hot tier = vocab/2: misses, evictions and write-backs all fire,
    and under SGD the run stays BITWISE equal to the full-table run
    seeded with the same host-store init."""
    feeds = _feeds(8)
    main, _s, scope, exe, loss, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=CFG.vocab_size // 2)
    host_init = {t: g.host[t].copy() for g in engine.groups
                 for t in g.table_names}
    cached = _train(main, scope, exe, loss, feeds, engine)
    counters = observability.get_counters()
    assert counters.get("embedding.cache_evictions", 0) > 0
    assert counters.get("embedding.cache_writebacks", 0) > 0
    # one device read per cached variable per eviction (tables, no state)
    assert counters["embedding.device_reads"] > 0

    fmain, _fs, fscope, fexe, floss, _fp, _fe = _build_deepfm(
        per_slot=True, fused=True)
    for name, arr in host_init.items():
        fscope.set_var(name, torch.as_tensor(arr))
    assert cached == _train(fmain, fscope, fexe, floss, feeds)


def test_cache_capacity_exceeds_device_tier():
    _m, _s, scope, _e, _l, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=CFG.vocab_size // 4)
    g = engine.groups[0]
    assert g.hot_rows * 4 == CFG.vocab_size
    assert scope.find_var("deepfm_emb").shape[0] == g.hot_rows
    assert g.host["deepfm_emb"].shape[0] == CFG.vocab_size
    assert g.host_bytes() > g.device_bytes()
    gauges = observability.get_gauges()
    assert gauges[f"embedding.vocab_rows.{g.name}"] == CFG.vocab_size
    assert gauges[f"embedding.hot_rows.{g.name}"] == g.hot_rows


def test_cache_hit_rate_and_histograms_recorded():
    feeds = _feeds(6)
    main, _s, scope, exe, loss, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=CFG.vocab_size // 2)
    _train(main, scope, exe, loss, feeds, engine)
    gauges = observability.get_gauges()
    hists = observability.get_histograms()
    name = engine.groups[0].name
    assert 0.0 < gauges[f"embedding.hot_hit_rate.{name}"] <= 1.0
    assert hists["embedding.unique_ids_per_batch"]["count"] == len(feeds)
    assert hists["embedding.dedup_ratio"]["count"] == len(feeds)
    assert hists["embedding.dedup_ratio"]["max"] < 1.0  # dedup active
    assert hists["embedding.host_fetch_latency"]["count"] > 0


def test_cache_refuses_batch_larger_than_hot_tier():
    _m, _s, scope, _e, _l, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=8)
    with pytest.raises(PreconditionNotMetError):
        engine.prepare_feed(_feeds(1)[0], scope)


def test_engine_requires_feed_level_ids():
    """Ids computed in-graph refuse at engine construction."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.data("x", [8, 1], "float32")
        ids = layers.cast(layers.scale(x, scale=100.0), "int64")
        _ = layers.sparse_embedding(
            ids, [32, 4], param_attr=fluid.ParamAttr(name="t"))
    with pytest.raises(InvalidArgumentError, match="computed in-graph"):
        EmbeddingEngine(main, startup, hot_rows=16)


def test_engine_refusals():
    """Unknown tables, a hot tier above the vocab, and use before
    attach refuse by name."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.data("feat_ids", [B, CFG.num_fields], "int64")
        label = fluid.data("label", [B, 1], "float32")
        deepfm(ids, label, CFG, per_slot=True)
        fuse_lookups(main)
        with pytest.raises(InvalidArgumentError, match="not sparse tables"):
            EmbeddingEngine(main, startup, hot_rows={"nope": 8})
        with pytest.raises(InvalidArgumentError, match="hot_rows must be"):
            EmbeddingEngine(main, startup, hot_rows=10 ** 6)
        engine = EmbeddingEngine(main, startup, hot_rows=64)
        with pytest.raises(PreconditionNotMetError, match="not attached"):
            engine.plan(_feeds(1)[0])


def test_cached_checkpoint_resume_bitwise(tmp_path):
    """flush + save_persistables + state_dict, then a rebuilt engine
    resumes the stream bitwise (Momentum: residency itself is state; no
    op of deepfm draws random numbers, so no stream position to carry)."""
    feeds = _feeds(6)

    def build():
        return _build_deepfm(per_slot=True, fused=True,
                             hot_rows=CFG.vocab_size // 2, opt="momentum")

    main, _s, scope, exe, loss, _p, engine = build()
    control = _train(main, scope, exe, loss, feeds, engine)

    main, _s, scope, exe, loss, _p, engine = build()
    got = _train(main, scope, exe, loss, feeds[:3], engine)
    ckpt = str(tmp_path / "ck")
    engine.flush(scope)
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, ckpt, main_program=main)
    np.savez(str(tmp_path / "estate.npz"), **engine.state_dict(scope))

    main, _s, scope, exe, loss, _p, engine = build()
    with fluid.scope_guard(scope):
        fluid.io.load_persistables(exe, ckpt, main_program=main)
    engine.load_state_dict(dict(np.load(str(tmp_path / "estate.npz"))),
                           scope)
    got += _train(main, scope, exe, loss, feeds[3:], engine)
    assert got == control


def test_delta_row_oracles_name_rows_written_back():
    """The tiered-checkpoint hooks: an oracle with no base asks for the
    full store; after a commit it names exactly the rows written back
    since (each consumer on its own cursor)."""
    main, _s, scope, exe, loss, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=CFG.vocab_size // 2)
    g = engine.groups[0]
    oracles = engine.delta_row_oracles(consumer="checkpoint")
    key = f"{g.name}::host::deepfm_emb"
    assert set(oracles) == {f"{g.name}::host::{t}" for t in g.table_names}
    rows, mark = oracles[key](None)
    assert rows is None and mark == 0
    engine.commit_row_marks("checkpoint", {key: mark})
    _train(main, scope, exe, loss, _feeds(8), engine)
    rows, mark2 = oracles[key](None)
    assert mark2 > mark and rows.size > 0
    np.testing.assert_array_equal(rows, g.dirty_rows_since(mark))
    assert engine.delta_row_oracles(consumer="publish")[key](None)[0] \
        is None


# ---------------------------------------------------------------------------
# async prefetch
# ---------------------------------------------------------------------------


def test_prefetcher_bitwise_and_overlap_recorded():
    feeds = _feeds(8)
    main, _s, scope, exe, loss, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=CFG.vocab_size // 2)
    sync = _train(main, scope, exe, loss, feeds, engine)
    observability.reset()

    main, _s, scope, exe, loss, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=CFG.vocab_size // 2)
    pre = []
    for f in Prefetcher(engine, feeds, scope):
        (lv,) = exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        pre.append(float(np.asarray(lv).reshape(-1)[0]))
    assert pre == sync
    hists = observability.get_histograms()
    assert hists["embedding.prefetch_overlap"]["count"] == len(feeds)
    assert observability.get_counters()["embedding.prefetch_batches"] \
        == len(feeds)
    plans = [s for s in observability.get_spans()
             if s["name"] == "embedding.prefetch_plan"]
    assert len(plans) == len(feeds)
    assert {s["tid"] for s in plans} != {threading.get_ident()}


def test_prefetcher_propagates_worker_errors():
    _m, _s, scope, _e, _l, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=CFG.vocab_size // 2)
    bad = [{"feat_ids": np.full((B, CFG.num_fields), 10 ** 6, np.int64),
            "label": np.zeros((B, 1), np.float32)}]
    with pytest.raises(InvalidArgumentError, match="outside"):
        for _ in Prefetcher(engine, bad, scope):
            pass


def test_multi_feed_group_translates_each_feed_once():
    """A table keyed by TWO feeds forms one multi-feed group: one plan
    covers both feeds and each is translated exactly once."""
    b, v, d = 8, 64, 4
    main, startup = fluid.Program(), fluid.Program()
    main.random_seed = startup.random_seed = 3
    scope = fluid.Scope()
    with fluid.program_guard(main, startup), fluid.scope_guard(scope), \
            fluid.unique_name.guard():
        user = fluid.data("user_ids", [b, 1], "int64")
        item = fluid.data("item_ids", [b, 1], "int64")
        both = layers.concat([user, item], axis=0)  # [2B, 1]
        out = layers.sparse_embedding(
            both, [v, d], param_attr=fluid.ParamAttr(name="t"))
        loss = layers.reduce_sum(layers.square(out))
        engine = EmbeddingEngine(main, startup, hot_rows=32)
        fluid.optimizer.SGD(0.05).minimize(loss)
        exe = fluid.Executor(CPU)
        exe.run(startup, scope=scope)
        engine.attach(scope)
        assert sorted(engine.groups[0].feeds) == ["item_ids", "user_ids"]
        rng = np.random.RandomState(0)
        for _ in range(3):
            feed = {
                "user_ids": rng.randint(0, v, (b, 1)).astype(np.int64),
                "item_ids": rng.randint(0, v, (b, 1)).astype(np.int64),
            }
            ff = engine.prepare_feed(feed, scope)
            assert ff["user_ids"].max() < 32 and ff["item_ids"].max() < 32
            (lv,) = exe.run(main, feed=ff, fetch_list=[loss], scope=scope)
            assert np.isfinite(lv).all()


def test_prefetcher_close_stops_feed_consumption():
    """close() after an early exit halts the worker."""
    _m, _s, scope, _e, _l, _p, engine = _build_deepfm(
        per_slot=True, fused=True, hot_rows=CFG.vocab_size // 2)
    consumed = []

    def src():
        for f in _feeds(100):
            consumed.append(1)
            yield f

    pf = Prefetcher(engine, src(), scope, depth=1)
    next(pf)
    pf.close()
    n = len(consumed)
    time.sleep(0.3)
    assert len(consumed) <= n + 1, "worker kept consuming after close()"
    assert not pf._thread.is_alive()
