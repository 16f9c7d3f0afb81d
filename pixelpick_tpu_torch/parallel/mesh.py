"""Batch padding for one device.

Counterpart of ``pixelpick_tpu/parallel/mesh.py:pad_batch_to_devices`` with
``target_rows`` only: the device meshes come with multi-GPU (ROADMAP.md,
Queue 1). A host-side NumPy function.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def pad_batch_to_devices(batch: dict, pad_label: Optional[int] = None,
                         target_rows: Optional[int] = None):
    """Pad a remainder batch to ``target_rows`` rows with inert duplicates
    of its last row; returns ``(padded_batch, n_real)``.

    The micro-batch train step pads a remainder megabatch to a multiple of
    the micro-batch size this way (``active/driver.py``). Every masking
    key of a pad row is overridden:

    - ``valid`` -> False: the sparse loss and the train confusion matrix
      read nothing of it;
    - ``y`` -> ``pad_label`` (the ignore index): the dense loss and the
      eval confusion matrix drop it;
    - ``excluded`` -> True: acquisition never picks it;
    - ``index`` -> -1: consumers that track images skip it.

    BatchNorm's batch moments still see the pad rows: they join the final
    micro-batch's moments, as in the JAX package."""
    b = next(iter(batch.values())).shape[0]
    if target_rows is None or target_rows <= b:
        return batch, b
    pad = target_rows - b
    out = {}
    for k, v in batch.items():
        v = np.asarray(v)
        out[k] = np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
    if "valid" in out:
        out["valid"][b:] = False
    if "y" in out and pad_label is not None:
        out["y"][b:] = pad_label
    if "excluded" in out:
        out["excluded"][b:] = True
    if "index" in out:
        out["index"][b:] = -1
    return out, b
