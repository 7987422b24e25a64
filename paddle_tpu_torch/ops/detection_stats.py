"""Detection padding observability (counterpart of
paddle_tpu/ops/detection_stats.py).

The batched detection ops keep shapes static with a fixed RoI cap an
image and validity masks, so the quantity to watch at run time is the
share of the cap that is dead padding. The live counts (RoisNum) are
fetched by the caller, which hands them to record_roi_stats:

* ``detection.rois_per_image`` histogram, live rois an image;
* ``detection.padding_waste`` gauge, the share of the batch's RoI-cap
  slots masked out (0: the cap fully used);
* ``detection.roi_batches_recorded`` counter.

The ops' own counters (``detection.<op>.instantiations`` and
``.batched_instantiations``) are ops/detection.py's _tally.
"""

from __future__ import annotations

import numpy as np

from ..observability import metrics

# bucket edges in rois an image, not seconds
ROI_COUNT_BUCKETS = (0, 1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)


def record_roi_stats(rois_num, cap):
    """Record one batch's live roi counts (`rois_num`, any array-like,
    e.g. the fetched RoisNum of batched generate_proposal_labels) against
    the RoI cap `cap` they are padded to; returns the padding-waste share
    written to the gauge."""
    arr = np.asarray(rois_num).reshape(-1).astype(np.int64)
    for n in arr:
        metrics.observe("detection.rois_per_image", float(n),
                        buckets=ROI_COUNT_BUCKETS)
    total = int(cap) * max(len(arr), 1)
    waste = 1.0 - float(arr.sum()) / total if total else 0.0
    metrics.set_gauge("detection.padding_waste", waste)
    metrics.add("detection.roi_batches_recorded")
    return waste
