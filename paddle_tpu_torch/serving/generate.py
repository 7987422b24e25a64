"""KV-cache GPT generation: prefill + single-token decode programs
(counterpart of paddle_tpu/serving/generate.py).

``GPTGenerator`` owns the two programs ``models/gpt.py`` splits the
decoder into and the Scope their cache persistables share:

* prefill: embed the [B, S] context once, fill every layer's
  ``gpt_l{i}_cache_{k,v}`` rows 0..S-1, emit the last position's logits;
* decode: embed one token at a runtime position, write its K/V rows into
  the caches in place (ops/kv_cache.py), attend over the cache, emit
  next-token logits.

A T-token generation is one prefill run and T-1 decode runs of fixed
shapes. ``generate_full_recompute`` keeps the plain re-run-the-whole-
context baseline for parity checks.

The JAX package's ``serving.*`` spans and counters come with the
observability port. ``load_params``/``save_params`` read and write
io.save's files.
"""

from __future__ import annotations

import numpy as np
import torch

from ..errors import InvalidArgumentError
from ..framework import Executor, Program, Scope, program_guard, scope_guard
from ..layers import data
from ..models.gpt import (
    gpt_cache_names,
    gpt_decode_step,
    gpt_logits,
    gpt_prefill,
)


class GPTGenerator:
    """Parameters -> tokens through the KV-cache decode path.

    Shapes are fixed at construction (the serving bucket contract):
    `batch` concurrent sequences, `context_len` prompt tokens, caches
    sized `max_len`. ``generate`` emits up to
    ``max_len - context_len`` tokens. The caches live on the executor's
    device (the card unless it was built with CPUPlace())."""

    def __init__(self, cfg, batch, context_len, max_len, scope=None,
                 executor=None):
        if context_len >= max_len:
            raise InvalidArgumentError(
                f"context_len {context_len} must leave room to generate "
                f"(max_len {max_len})"
            )
        self.cfg = cfg
        self.batch = int(batch)
        self.context_len = int(context_len)
        self.max_len = int(max_len)
        self.scope = scope or Scope()
        self.executor = executor or Executor()

        self.prefill_prog = Program()
        self.startup_prog = Program()
        with program_guard(self.prefill_prog, self.startup_prog):
            ids = data("context_ids", [batch, context_len], "int64")
            logits = gpt_prefill(ids, cfg, max_len)
        self._prefill_fetch = [logits.name]

        self.decode_prog = Program()
        decode_startup = Program()  # same init ops; never run
        with program_guard(self.decode_prog, decode_startup):
            tok = data("token_ids", [batch, 1], "int64")
            pos = data("pos_ids", [1, 1], "int64")
            dlogits = gpt_decode_step(tok, pos, cfg, max_len)
        self._decode_fetch = [dlogits.name]

        # both are inference programs: the executor runs them in test mode
        self.prefill_prog._is_inference = True
        self.decode_prog._is_inference = True
        self._recompute = None  # (length, program, fetch)

    # -- parameters --------------------------------------------------------
    def init_params(self, seed=0):
        """Random-init parameters from `seed` (the bench and test path).
        Runs the prefill startup program once."""
        self.startup_prog.random_seed = seed
        self.prefill_prog.random_seed = seed
        self.decode_prog.random_seed = seed
        self.executor.run(self.startup_prog, scope=self.scope)
        self.reset()

    def _param_vars(self):
        caches = set(gpt_cache_names(self.cfg))
        return [v for v in self.prefill_prog.list_vars()
                if v.persistable and v.name not in caches]

    def load_params(self, path):
        """Load trained GPT parameters (io.save's files, written by either
        package) into the shared scope on the executor's device; the KV
        caches are runtime state, not checkpoint content."""
        from .. import io as _io

        with scope_guard(self.scope):
            _io.load(self.prefill_prog, path, var_list=self._param_vars(),
                     executor=self.executor)
        self.reset()

    def save_params(self, path):
        """io.save of the prefill program's persistables."""
        from .. import io as _io

        with scope_guard(self.scope):
            return _io.save(self.prefill_prog, path)

    def reset(self):
        """Zero the KV caches (fresh generation state)."""
        shape = (self.batch, self.max_len, self.cfg.hidden_size)
        for name in gpt_cache_names(self.cfg):
            self.scope.set_var(name, torch.zeros(
                shape, dtype=torch.float32, device=self.executor.device))

    # -- generation --------------------------------------------------------
    def _check_len(self, max_new_tokens):
        if int(max_new_tokens) < 1:
            raise InvalidArgumentError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}"
            )
        t_total = self.context_len + int(max_new_tokens)
        if t_total > self.max_len:
            raise InvalidArgumentError(
                f"context {self.context_len} + {max_new_tokens} new tokens "
                f"exceeds max_len {self.max_len}"
            )
        return t_total

    def prefill(self, context_ids):
        """Run the prefill program on a [B, context_len] context, filling
        the caches rows 0..context_len-1; returns the last position's
        logits [B, 1, V] on the executor's device."""
        ids = np.asarray(context_ids)
        if ids.shape != (self.batch, self.context_len):
            raise InvalidArgumentError(
                f"context_ids must be [{self.batch}, {self.context_len}], "
                f"got {ids.shape}"
            )
        (logits,) = self.executor.run(
            self.prefill_prog, feed={"context_ids": ids},
            fetch_list=self._prefill_fetch, scope=self.scope,
            return_numpy=False,
        )
        return logits

    def decode(self, token_ids, pos):
        """Run one decode step: embed the [B] tokens at cache position
        `pos`, write their K/V rows, attend over the cache; returns the
        next-token logits [B, 1, V] on the executor's device."""
        (logits,) = self.executor.run(
            self.decode_prog,
            feed={"token_ids": np.asarray(token_ids, np.int64)[:, None],
                  "pos_ids": np.array([[pos]], np.int64)},
            fetch_list=self._decode_fetch, scope=self.scope,
            return_numpy=False,
        )
        return logits

    def generate(self, context_ids, max_new_tokens, greedy=True):
        """Generate `max_new_tokens` per sequence; returns [B, T] int64.

        Greedy decoding (argmax), the deterministic contract the parity
        checks rely on; sampling policies plug in at the caller by reading
        logits instead (prefill, decode)."""
        if not greedy:
            raise InvalidArgumentError(
                "only greedy decoding is implemented; sample from the "
                "logits at the caller for other policies"
            )
        self._check_len(max_new_tokens)
        self.reset()
        out = np.zeros((self.batch, max_new_tokens), np.int64)
        out[:, 0] = _argmax(self.prefill(context_ids)[:, -1])
        for t in range(1, max_new_tokens):
            # the fed token sits at position context_len + t - 1
            logits = self.decode(out[:, t - 1], self.context_len + t - 1)
            out[:, t] = _argmax(logits[:, -1])
        return out

    def full_recompute_logits(self, full_ids):
        """Logits [B, T, V] (on the executor's device) of a plain
        ``gpt_logits`` program over [B, T] ids, from the shared scope."""
        t_total = np.asarray(full_ids).shape[1]
        if self._recompute is None or self._recompute[0] != t_total:
            prog = Program()
            startup = Program()  # params come from the scope
            with program_guard(prog, startup):
                full = data("full_ids", [self.batch, t_total], "int64")
                logits = gpt_logits(full, self.cfg, is_test=True)
            prog._is_inference = True
            self._recompute = (t_total, prog, [logits.name])
        _, prog, fetch = self._recompute
        (logits,) = self.executor.run(
            prog, feed={"full_ids": np.asarray(full_ids)}, fetch_list=fetch,
            scope=self.scope, return_numpy=False,
        )
        return logits

    def generate_full_recompute(self, context_ids, max_new_tokens):
        """The plain baseline: re-run the FULL context through a
        ``gpt_logits`` program for every emitted token (one fixed padded
        shape)."""
        t_total = self._check_len(max_new_tokens)
        padded = np.zeros((self.batch, t_total), np.int64)
        padded[:, :self.context_len] = np.asarray(context_ids)
        out = np.zeros((self.batch, max_new_tokens), np.int64)
        cur = self.context_len
        for t in range(max_new_tokens):
            logits = self.full_recompute_logits(padded)
            out[:, t] = _argmax(logits[:, cur - 1])
            if cur < t_total:
                padded[:, cur] = out[:, t]
            cur += 1
        return out


def _argmax(logits):
    """Greedy tokens of [B, V] logits, taken on their device (only B ints
    cross to the host); the first maximum wins, as numpy's argmax."""
    return logits.argmax(-1).cpu().numpy()


class GPTGenerateRunner:
    """Router runner wrapping a GPTGenerator: a "generate" endpoint whose
    batched dispatch is one prefill + T decode steps. The endpoint bucket
    must equal the generator's batch (cache shapes are static)."""

    def __init__(self, generator, max_new_tokens):
        self.generator = generator
        self.max_new_tokens = int(max_new_tokens)
        self.feed_names = ("context_ids",)

    def validate_config(self, config):
        """Endpoint hook: cache shapes are static, so every configured
        bucket must equal the generator's batch exactly."""
        bad = [b for b in config.buckets if b != self.generator.batch]
        if bad:
            raise InvalidArgumentError(
                f"GPT generate endpoint buckets {config.buckets} must all "
                f"equal the generator batch {self.generator.batch} (cache "
                "shapes are static)"
            )

    def sample_spec(self, name):
        return (self.generator.context_len,), "int64"

    def run(self, feed):
        return [
            self.generator.generate(feed["context_ids"], self.max_new_tokens)
        ]
