"""Timing + profiling helpers.

The reference's only timing is ctime prints at start/end
(``NB_LDPC.c:140-142,565-584``).  Here: wall-clock section timers that
force device completion, and a thin wrapper over the JAX/XLA profiler for
device trace capture.
"""
from __future__ import annotations

import contextlib
import time


@contextlib.contextmanager
def timer(label: str, sink: dict | None = None, sync=None):
    """Context timer; ``sync`` is an optional array/list to block on."""
    t0 = time.perf_counter()
    yield
    if sync is not None:
        import numpy as np

        arrs = sync if isinstance(sync, (list, tuple)) else [sync]
        for a in arrs:
            np.asarray(a)
    dt = time.perf_counter() - t0
    if sink is not None:
        sink[label] = sink.get(label, 0.0) + dt
    else:
        print(f"[{label}] {dt*1e3:.2f} ms")


@contextlib.contextmanager
def xla_trace(logdir: str):
    """Capture an XLA profiler trace viewable in TensorBoard/XProf."""
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
