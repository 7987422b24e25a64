"""Embedding engine (counterpart of paddle_tpu/embedding), the CTR
workhorse, in three pieces:

* :func:`fuse_lookups` (engine.py) — same-width ``sparse_embedding``
  lookups coalesce into ONE ``fused_lookup_table`` op over a concatenated
  id space: batch-unique ids dedup once, one gather serves every slot,
  and the backward is one segment-sum scatter per table (DeepFM: 2F
  lookup sites -> 2).
* :class:`CachedGroup` tiers (cache.py) — a frequency-tracked hot-rows
  tier resident on the card with a host-memory cold store, so
  ``vocab_size`` can exceed the card's memory; eviction by access count,
  write-back of trained rows and optimizer state.
* :class:`Prefetcher` (prefetch.py) — the next batch's ids are extracted
  and their cold rows staged host-side while the current step computes.

The JAX package's sharded tables and int8 gradient exchange are ROADMAP
Queue 1 item 6. Telemetry lands under ``embedding.*`` (observability/).
"""

from .cache import CachedGroup  # noqa: F401
from .engine import EmbeddingEngine, fuse_lookups  # noqa: F401
from .prefetch import Prefetcher  # noqa: F401
