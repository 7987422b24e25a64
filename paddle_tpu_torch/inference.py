"""Inference predictor API (counterpart of paddle_tpu/inference.py;
reference paddle/fluid/inference/: AnalysisConfig
paddle_analysis_config.h, AnalysisPredictor analysis_predictor.cc,
create_paddle_predictor, PaddleTensor, ZeroCopyTensor).

A Predictor loads an inference model written by save_inference_model (of
either package) into a scope of its own and runs it through the eager
Executor, on the card unless its config is handed `CPUPlace()`. The
knobs that act:

  * disable_gpu() / enable_use_gpu(device_id=) — the place (or the
                               config's `place` argument);
  * enable_bf16()            — rewrites the program with the AMP lists
                               (contrib.mixed_precision) to bfloat16, so
                               the matmuls and attention run on bf16
                               activations;
  * set_batch_buckets([...]) — pads a run's batch up to the nearest bucket
                               and slices the padding off batch-leading
                               fetches, so a server sees a few shapes.

The JAX package's XLA-only knobs (a persistent compilation cache, AOT
executables) have nothing to act on in an eager executor that compiles
nothing; they raise UnimplementedError (ROADMAP Queue 1, "the rest of
serving and the operations planes"). The parity shims (glog, IR optim,
memory optim) are accepted and do nothing.
"""

from __future__ import annotations

import warnings

import numpy as np

from .errors import (
    InvalidArgumentError,
    PreconditionNotMetError,
    UnimplementedError,
)

_XLA_ONLY = ("the eager executor compiles nothing to cache or serialize "
             "(ROADMAP Queue 1, the rest of serving and the operations "
             "planes: the XLA-only predictor knobs)")


class AnalysisConfig:
    """Where the model is and how to run it. `place`: CPUPlace() runs on
    the CPU; None (the default) runs on CUDAPlace(0). disable_gpu() and
    enable_use_gpu(device_id=) set it as the reference's switches do."""

    def __init__(self, model_dir=None, params_file=None, model_file=None,
                 place=None):
        self.model_dir = model_dir
        self.params_file = params_file
        self.model_file = model_file
        self._use_feed_fetch_ops = False
        self._switch_ir_optim = True
        self._bf16 = False
        self._batch_buckets = None
        self._place = place

    # -- knobs that act -------------------------------------------------
    def enable_bf16(self):
        """Run the white-list ops (matmuls, attention) in bfloat16 (the
        reference's enable_mkldnn_bfloat16)."""
        self._bf16 = True

    def set_batch_buckets(self, sizes):
        """Pad run() batches up to the nearest of `sizes`. Contract: all
        feeds share the leading batch axis, and fetches are per-sample
        with the batch leading; a fetch that reduces over the batch would
        include the zero padding rows."""
        sizes = sorted(int(s) for s in sizes)
        if not sizes or sizes[0] <= 0:
            raise InvalidArgumentError(
                f"batch buckets must be positive, got {sizes}")
        self._batch_buckets = sizes

    def enable_use_gpu(self, memory_pool_init_size_mb=0, device_id=0):
        from .core.place import CUDAPlace

        self._place = CUDAPlace(device_id)

    def disable_gpu(self):
        from .core.place import CPUPlace

        self._place = CPUPlace()

    # -- the JAX package's XLA-only knobs ---------------------------------
    def set_optim_cache_dir(self, path):
        raise UnimplementedError(f"set_optim_cache_dir: {_XLA_ONLY}")

    def set_aot_executable_path(self, path):
        raise UnimplementedError(f"set_aot_executable_path: {_XLA_ONLY}")

    # -- parity shims -----------------------------------------------------
    def disable_glog_info(self):
        pass

    def switch_ir_optim(self, flag=True):
        self._switch_ir_optim = flag

    def switch_use_feed_fetch_ops(self, flag):
        self._use_feed_fetch_ops = flag

    def enable_memory_optim(self):
        pass


class PaddleTensor:
    """Host-side input/output tensor (reference paddle_api.h)."""

    def __init__(self, data=None, name=""):
        self.name = name
        self.data = np.asarray(data) if data is not None else None

    def as_ndarray(self):
        return np.asarray(self.data)


class Predictor:
    """AnalysisPredictor parity: load once, run many."""

    def __init__(self, config):
        from . import io as _io
        from .framework.executor import Executor
        from .framework.scope import Scope, scope_guard

        if config.model_dir is None:
            raise InvalidArgumentError("AnalysisConfig.model_dir is required")
        self._config = config
        self._scope = Scope()
        self._exe = Executor(config._place)
        with scope_guard(self._scope):
            (self._program, self._feed_names,
             self._fetch_vars) = _io.load_inference_model(
                config.model_dir, self._exe,
                model_filename=config.model_file,
                params_filename=config.params_file)
        if config._bf16:
            from .contrib.mixed_precision import (AutoMixedPrecisionLists,
                                                  fp16_utils)

            fp16_utils.rewrite_program(self._program,
                                       AutoMixedPrecisionLists(),
                                       dest_dtype="bfloat16")
        self._last_outputs = None  # kept alive for zero-copy readers
        self._batch_leading_cache = {}
        self._bucket_warned = set()

    @property
    def program(self):
        return self._program

    @property
    def executor(self):
        return self._exe

    @property
    def scope(self):
        return self._scope

    def get_input_names(self):
        return list(self._feed_names)

    def get_output_names(self):
        return [v if isinstance(v, str) else v.name
                for v in self._fetch_vars]

    def save_executable(self, path, sample_inputs):
        raise UnimplementedError(f"save_executable: {_XLA_ONLY}")

    # -- run ------------------------------------------------------------
    def _feed_dict(self, inputs):
        return {name: (t.data if isinstance(t, PaddleTensor)
                       else np.asarray(t))
                for name, t in zip(self._feed_names, inputs)}

    def _bucketed(self, feed):
        """(feed padded along the batch axis up to its bucket, the
        original batch or None)."""
        buckets = self._config._batch_buckets
        if not buckets:
            return feed, None
        b = next(iter(feed.values())).shape[0]
        for name, a in feed.items():
            if a.shape[0] != b:
                raise InvalidArgumentError(
                    f"batch bucketing needs a shared leading batch axis; "
                    f"feed {name!r} has {a.shape[0]}, expected {b}")
        target = next((s for s in buckets if s >= b), None)
        if target is None:
            raise PreconditionNotMetError(
                f"batch {b} exceeds the largest configured bucket "
                f"{buckets[-1]}")
        if target == b:
            return feed, None
        padded = {
            k: np.concatenate(
                [a, np.zeros((target - b,) + a.shape[1:], a.dtype)], axis=0)
            for k, a in ((k, np.asarray(a)) for k, a in feed.items())
        }
        return padded, b

    def _fetch_batch_leading(self, name):
        """(declared shape has a dynamic leading dim, declared shape): only
        then is slicing the bucket padding off verifiably right."""
        if name not in self._batch_leading_cache:
            var = self._program.global_block._find_var_recursive(name)
            declared = getattr(var, "shape", None)
            self._batch_leading_cache[name] = (
                declared is not None and len(declared) > 0
                and declared[0] in (-1, None), declared)
        return self._batch_leading_cache[name]

    def _unpad_out(self, o, name, orig_b, bucket):
        """Slice the padding off a fetch whose declared shape is
        batch-leading and whose leading dim is the bucket; otherwise warn
        once per fetch and return it whole (set_batch_buckets contract)."""
        batch_leading, declared = self._fetch_batch_leading(name)
        if (batch_leading and getattr(o, "ndim", 0) > 0
                and o.shape[0] == bucket):
            return o[:orig_b]
        if name in self._bucket_warned:
            return o
        self._bucket_warned.add(name)
        if getattr(o, "ndim", 0) > 0 and o.shape[0] == bucket:
            warnings.warn(
                f"bucketed fetch {name!r} has leading dim == bucket size "
                f"but its declared shape {declared} is not batch-leading; "
                "returning it un-sliced (set_batch_buckets contract)",
                RuntimeWarning, stacklevel=3)
        elif not batch_leading and declared is not None:
            warnings.warn(
                f"bucketed fetch {name!r} (declared shape {declared}) is "
                "not batch-leading; if it reduces over the batch the "
                "zero-pad rows are included (set_batch_buckets contract)",
                RuntimeWarning, stacklevel=3)
        return o

    def run(self, inputs):
        """inputs: PaddleTensors or arrays in feed order -> a PaddleTensor
        per fetch (reference PaddlePredictor::Run)."""
        feed, orig_b = self._bucketed(self._feed_dict(inputs))
        outs = self._exe.run(self._program, feed=feed,
                             fetch_list=self._fetch_vars, scope=self._scope)
        names = self.get_output_names()
        if orig_b is not None:
            bucket = next(iter(feed.values())).shape[0]
            outs = [self._unpad_out(o, name, orig_b, bucket)
                    for o, name in zip(outs, names)]
        return [PaddleTensor(o, name=n) for o, n in zip(outs, names)]

    def run_zero_copy(self, inputs):
        """Like run(), but returns (names, arrays): C-contiguous arrays the
        predictor owns until the next run, read in place by the caller."""
        outs = self.run(inputs)
        arrays = [np.ascontiguousarray(t.as_ndarray()) for t in outs]
        self._last_outputs = arrays
        return [t.name for t in outs], arrays


def create_paddle_predictor(config):
    return Predictor(config)
