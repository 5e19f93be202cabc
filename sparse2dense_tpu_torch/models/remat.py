"""Rematerialisation in training (the reference's ``nn.remat`` of the dense
backbone stages, ``scn.py`` ``_dense_mods``, and of the PCR generators,
``S2D_RPN._pcr``).

``remat(fn, *args, name=...)`` runs ``fn`` under a non-reentrant
``torch.utils.checkpoint``: the forward keeps only ``fn``'s inputs for the
backward, which runs ``fn`` again to rebuild what its gradient needs. Flax
keeps the ``batch_stats`` its forward computed and drops the recompute's, so
a layer that updates state in its forward (``norm.BatchNorm``'s running
statistics) asks :func:`recomputing` and skips the update during the
recompute; what the layer returns is the same either way.
"""
from __future__ import annotations

import collections
import contextlib
import threading

from torch.utils.checkpoint import checkpoint

# rematerialised calls and their recomputes, by ``name``: what a test reads
# to see that a module really ran under the checkpoint
calls: collections.Counter = collections.Counter()
recomputes: collections.Counter = collections.Counter()

# the recompute runs in the thread of the backward that needs it (autograd
# runs a CUDA backward in a thread of its own), so the flag is per thread
_state = threading.local()


def recomputing() -> bool:
    """True while a rematerialised function runs again in the backward."""
    return getattr(_state, "recomputing", False)


@contextlib.contextmanager
def _recompute(name: str):
    recomputes[name] += 1
    outer = recomputing()
    _state.recomputing = True
    try:
        yield
    finally:
        _state.recomputing = outer


def remat(fn, *args, name: str):
    """``fn(*args)``, its activations rebuilt in the backward instead of kept."""
    calls[name] += 1
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=lambda: (contextlib.nullcontext(), _recompute(name)))
