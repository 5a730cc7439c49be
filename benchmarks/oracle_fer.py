"""Native-oracle FER on the flagship anchor (EMS_VALIDATION.md section 2).

Runs the exact 8-bubble C++ oracle (csrc/nbldpc_core.cpp, OpenMP over
frames) on framework-generated BPSK-AWGN LLRs — the same channel the
framework's list-EMS measurement uses — so the oracle column of
EMS_VALIDATION can be given statistics matching the framework column (round-2 VERDICT weak item 4).

Usage: python benchmarks/oracle_fer.py [matrix] [ebn0] [frames] [seed]
"""
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, ".")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from ems_nbldpc_tpu import native  # noqa: E402
from ems_nbldpc_tpu.models import registry  # noqa: E402
from ems_nbldpc_tpu.models.channels import (  # noqa: E402
    ChannelSpec, bpsk_awgn, sigma_for,
)
from ems_nbldpc_tpu.utils.stats import wilson_ci  # noqa: E402


def main(matrix="Declercq_64800_R12_GF256", ebn0=1.5, frames=256, seed=17,
         nm=32, offset=0.3, nboper=64, iters=10, chunk=32):
    code = registry.get_code(matrix)
    sigma = sigma_for(ChannelSpec(), ebn0, code.rate)
    errs = tot = 0
    itsum = 0
    key = jax.random.PRNGKey(seed)
    import jax.numpy as jnp
    while tot < frames:
        key, sub = jax.random.split(key)
        f = min(chunk, frames - tot)
        cw = jnp.zeros((f, code.n), jnp.int32)  # all-zero cw (symmetric ch)
        intr, _ = bpsk_awgn(sub, cw, code.q, sigma)
        dec, its, _conv = native.decode_batch(
            code, np.asarray(intr, np.float64), max_iters=iters, nm=nm,
            offset=offset, nb_oper=nboper,
        )
        errs += int((dec != 0).any(axis=1).sum())
        itsum += int(its.sum())
        tot += f
        lo, hi = wilson_ci(errs, tot)
        print(f"{tot} frames: FER={errs}/{tot}={errs / tot:.4f} "
              f"[{lo:.4f},{hi:.4f}] avg_it={itsum / tot:.2f}", flush=True)


if __name__ == "__main__":
    a = sys.argv[1:]
    main(a[0] if a else "Declercq_64800_R12_GF256",
         float(a[1]) if len(a) > 1 else 1.5,
         int(a[2]) if len(a) > 2 else 256,
         int(a[3]) if len(a) > 3 else 17)
