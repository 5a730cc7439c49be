"""F-sweep probe for the list-EMS batch-scaling anomaly (VERDICT r2 #7).

Times ONE jitted compressed-stepper iteration at several F on the
flagship code, for NBLDPC_LISTSORT in {native, flat}.  Set the env var
before launch; run once per mode (the flag is read at trace time).

Usage: NBLDPC_LISTSORT=flat python benchmarks/list_f_probe.py [Fs...]
"""
import os
import sys
import time

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ems_nbldpc_tpu.decoder.graph import DeviceGraph  # noqa: E402
from ems_nbldpc_tpu.decoder.layered import (  # noqa: E402
    make_layered_list_stepper,
)
from ems_nbldpc_tpu.models import registry  # noqa: E402
from ems_nbldpc_tpu.models.channels import (  # noqa: E402
    ChannelSpec, bpsk_awgn, sigma_for,
)


def main(fs):
    mode = os.environ.get("NBLDPC_LISTSORT", "native")
    code = registry.get_code("Declercq_64800_R12_GF256")
    g = DeviceGraph.from_code(code)
    sigma = sigma_for(ChannelSpec(), 1.8, code.rate)
    for F in fs:
        key = jax.random.PRNGKey(0)
        cw = jnp.zeros((F, code.n), jnp.int32)
        intr, _ = bpsk_awgn(key, cw, code.q, sigma)
        init_fn, step_fn = make_layered_list_stepper(
            g, nm=32, offset=0.3, nboper=64, dtype=jnp.bfloat16)
        st = init_fn(intr)
        st = step_fn(st)
        np.asarray(st[0])   # compile+run 1 (sync on app)
        ts = []
        for _ in range(3):
            t0 = time.perf_counter()
            st = step_fn(st)
            np.asarray(st[0])
            ts.append(time.perf_counter() - t0)
        print(f"mode={mode} F={F}: {min(ts):.3f} s/iter "
              f"({F / min(ts):.1f} frames/s per iter) reps="
              f"{['%.3f' % t for t in ts]}", flush=True)


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [64, 128, 192, 256])
