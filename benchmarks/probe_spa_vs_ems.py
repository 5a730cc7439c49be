"""A/B probe on the flagship code: compressed EMS vs dense SPA layered.

Times a few decoder iterations of each on the GPU.
"""
import sys
import time

sys.path.insert(0, ".")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from ems_nbldpc_tpu.decoder.graph import DeviceGraph  # noqa: E402
from ems_nbldpc_tpu.decoder.layered import (  # noqa: E402
    make_layered_compressed_stepper, make_layered_stepper,
)
from ems_nbldpc_tpu.models import registry  # noqa: E402
from ems_nbldpc_tpu.models.channels import (  # noqa: E402
    ChannelSpec, bpsk_awgn, sigma_for,
)


def timed_steps(name, init_fn, step_fn, intr, nsteps=3):
    t0 = time.time()
    state = init_fn(intr)
    np.asarray(state[-2])
    print(f"{name}: init+compile {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    state = step_fn(state)
    np.asarray(state[-2])
    print(f"{name}: step compile+run {time.time()-t0:.1f}s", flush=True)
    t0 = time.time()
    for _ in range(nsteps):
        state = step_fn(state)
    np.asarray(state[-2])
    dt = (time.time() - t0) / nsteps
    conv = float(np.asarray(state[-2]).mean())
    print(f"{name}: {dt:.3f}s/iter (conv={conv:.2f})", flush=True)
    return dt


def main(frames=32, ebn0=1.8, which="all"):
    code = registry.get_code("Declercq_64800_R12_GF256")
    g = DeviceGraph.from_code(code)
    cw = jnp.zeros((frames, code.n), jnp.int32)
    sigma = sigma_for(ChannelSpec(), ebn0, code.rate)
    intr, _ = bpsk_awgn(jax.random.PRNGKey(0), cw, 256, sigma)
    intr16 = intr.astype(jnp.bfloat16)

    if which in ("all", "ems"):
        i_fn, s_fn = make_layered_compressed_stepper(g, 32, 0.3)
        timed_steps("ems-compressed-bf16", i_fn, s_fn, intr16)
    if which in ("all", "spa"):
        i_fn, s_fn = make_layered_stepper(g, 0, 0.0, cn="spa")
        timed_steps("spa-dense-f32", i_fn, s_fn, intr)
    if which in ("all", "spa16"):
        i_fn, s_fn = make_layered_stepper(g, 0, 0.0, cn="spa")
        timed_steps("spa-dense-bf16", i_fn, s_fn, intr16)


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    frames = int(sys.argv[2]) if len(sys.argv) > 2 else 32
    main(frames=frames, which=which)
