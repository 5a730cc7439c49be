"""Quantify the ems2/ems3 min3-cache approximation on realistic inputs.

Round-3 VERDICT missing-item 3: the repo computes the exact per-edge
decorrelated minimum that the reference's dormant ``syndrome_ems2/3``
specializations (``syndrome_decoder.c:659-1303``) approximate with a
per-bucket 3-min cache, and pins the dominance relationship — but
"nobody has measured whether their min3-cache approximation is ever the
better speed/quality trade on the device".  This script measures the QUALITY
side on channel-realistic message lists (sorted AWGN-BPSK intrinsics at
waterfall SNRs): how often the cache misses (substituting an optimistic
min3) and by how much.

The SPEED side is structural, not empirical: our exact
decorrelation is ONE vectorized masked-min over the (k+1)-entry bucket
lists per edge (ops/syndrome_cn.py) — the same sorted packed-key
machinery the min3 cache would need anyway; a cache would save no sorts,
only narrow the per-edge min width from k+1 to 3, while costing the
accuracy measured here.  On a scalar CPU the cache removes an O(C) pass
per edge — that is the machine the reference built it for.

Usage: python benchmarks/ems23_study.py   (CPU, ~1 min)
"""
import sys

sys.path.insert(0, ".")

import os  # noqa: E402

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, "tests")
from test_syndrome_ems23 import SAT, ems2_oracle  # noqa: E402

from ems_nbldpc_tpu.ops.syndrome_cn import build_config_table  # noqa: E402


def realistic_lists(rng, dc, nm, q, ebn0_db, rate=0.5):
    """Sorted top-nm (vals, gfs) of AWGN-BPSK intrinsics — what the CN
    sees in iteration 1 (message statistics only sharpen afterwards)."""
    logq = int(np.log2(q))
    sigma = np.sqrt(1.0 / (2 * rate * 10 ** (ebn0_db / 10)))
    bits = np.where(
        (np.arange(q)[:, None] >> np.arange(logq)[None]) & 1, -1.0, 1.0
    )
    y = 1.0 + sigma * rng.standard_normal((dc, logq))
    cost = ((y[:, None, :] - bits[None]) ** 2).sum(-1) / (2 * sigma**2)
    order = np.argsort(cost, axis=-1)[:, :nm]
    vals = np.take_along_axis(cost, order, axis=-1)
    return vals - vals[:, :1], order.astype(np.int64)


def exact_decorrelated(vals, gfs, cfg, q):
    """Exact per-edge decorrelated bucket-min (what syndrome_checknode
    computes): out[t, s] = min llr[i] over configs i with syndrome
    s ^ gfs[t][0] that do NOT deviate on edge t."""
    c, dc = cfg.shape
    llr = np.zeros(c)
    synd = np.zeros(c, np.int64)
    for t in range(dc):
        llr = llr + vals[t][cfg[:, t]]
        synd = synd ^ gfs[t][cfg[:, t]]
    out = np.full((dc, q), SAT)
    for t in range(dc):
        ok = cfg[:, t] == 0
        for i in np.flatnonzero(ok):
            s = int(synd[i]) ^ int(gfs[t][0])
            if llr[i] < out[t, s]:
                out[t, s] = llr[i]
    return out


def main():
    """NOTE on the possible miss modes: ``check_deviation``
    (syndrome_decoder.c:2232-2283) only admits a min3 whose three cached
    configs have a deviation-free entry on EVERY edge, so an *optimistic*
    substitution (finite min3 that deviates on the edge) is structurally
    impossible — confirmed by construction in the oracle.  The only real
    approximation loss is PESSIMISTIC: a bucket whose 3-entry cache holds
    no deviation-free config for some edge returns saturation where the
    exact decorrelated min is finite.  That loss rate is what we measure.
    """
    rng = np.random.default_rng(0)
    for q, dc, nm, d, cap, ebn0, label in [
        (64, 12, 30, (7, 3, 2), 500, 3.0, "Mat212-class"),
        (64, 12, 30, (7, 3, 2), 500, 4.0, "Mat212-class"),
        # flagship-class; nm must exceed d1 (the C NbMax>=d1+1 OOB trap,
        # results_r3/SYNDROME_GF256.md) — the C anchors use NbMax=45
        (256, 4, 45, (40, 15, 5), 1000, 1.8, "flagship-class"),
        (256, 20, 32, (12, 5, 3), 1000, 3.8, "Ahmed-class"),
    ]:
        cfg = build_config_table(dc, *d, "trapeze", cap)
        lost, lost_margin, finite_f, n_t = 0.0, [], 0.0, 0
        for _ in range(12):
            vals, gfs = realistic_lists(rng, dc, nm, q, ebn0)
            ems2, case = ems2_oracle(vals, gfs, cfg, q)
            exact = exact_decorrelated(vals, gfs, cfg, q)
            finite = exact < SAT
            loss = finite & (ems2 >= SAT)    # info thrown away by the cache
            finite_f += finite.mean()
            lost += loss.sum() / max(finite.sum(), 1)
            if loss.any():
                lost_margin.append(float(np.mean(exact[loss])))
            n_t += 1
        lm = np.mean(lost_margin) if lost_margin else float("nan")
        print(f"[{label}] q={q} dc={dc} nm={nm} @{ebn0} dB: "
              f"exact-finite buckets {finite_f / n_t:.1%} of (edge,symbol); "
              f"cache-exhaustion loss {lost / n_t:.3%} of those "
              f"(mean lost-entry LLR {lm:.1f})", flush=True)
    print("done")


if __name__ == "__main__":
    main()
