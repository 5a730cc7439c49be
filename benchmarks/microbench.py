"""Microbenchmarks for the CN primitive variants.

Run on the GPU to pick implementations:
    python benchmarks/microbench.py
"""
import time

import jax
import jax.numpy as jnp
import numpy as np


def bench(fn, *args, n=20):
    r = fn(*args)
    jax.tree.map(np.asarray, r)
    t0 = time.time()
    for _ in range(n):
        r = fn(*args)
    jax.tree.map(np.asarray, r)
    return (time.time() - t0) / n


def xor_gather_flip(a, g):
    q = a.shape[-1]
    lead = a.shape[:-1]
    for b in range(q.bit_length() - 1):
        s = 1 << b
        sw = a.reshape(lead + (q // (2 * s), 2, s))[..., ::-1, :].reshape(
            lead + (q,))
        a = jnp.where(((g >> b) & 1).astype(bool)[..., None], sw, a)
    return a


def xor_gather_roll(a, g):
    q = a.shape[-1]
    iota = jnp.arange(q)
    for b in range(q.bit_length() - 1):
        s = 1 << b
        lo = (iota & s) == 0          # static lane mask
        sw = jnp.where(lo, jnp.roll(a, -s, axis=-1), jnp.roll(a, s, axis=-1))
        a = jnp.where(((g >> b) & 1).astype(bool)[..., None], sw, a)
    return a


def mc_vec(xg):
    def f(a, bv, bg):
        nm = bv.shape[-1]
        ax = xg(jnp.broadcast_to(a[..., None, :],
                                 a.shape[:-1] + (nm, a.shape[-1])), bg)
        return jnp.min(bv[..., :, None] + ax, axis=-2)
    return f


def mc_scan(xg):
    def f(a, bv, bg):
        nm = bv.shape[-1]
        def body(j, acc):
            return jnp.minimum(acc, bv[..., j, None] + xg(a, bg[..., j]))
        return jax.lax.fori_loop(
            1, nm, body, bv[..., 0, None] + xg(a, bg[..., 0]))
    return f


def main():
    rng = np.random.default_rng(0)
    print(jax.devices())
    for (T, q, nm) in [(24576, 64, 30), (32400, 256, 32)]:
        a = jnp.asarray(rng.random((T, q)).astype(np.float32) * 9)
        b = jnp.asarray(rng.random((T, q)).astype(np.float32) * 9)
        g = jnp.asarray(rng.integers(0, q, (T,)), jnp.int32)
        perm = jnp.asarray(rng.permutation(q).astype(np.int32))
        permT = jnp.asarray(
            np.stack([rng.permutation(q) for _ in range(T)]).astype(np.int32))

        topk = jax.jit(lambda x: jax.lax.top_k(-x, nm))
        atopk = jax.jit(lambda x: jax.lax.approx_max_k(-x, nm))
        print(f"-- T={T} q={q} nm={nm}")
        print(f"top_k         {bench(topk, b)*1e3:8.2f} ms")
        print(f"approx_top_k  {bench(atopk, b)*1e3:8.2f} ms")

        bv, bg = topk(b)
        bv = -bv

        for name, xg in [("flip", xor_gather_flip), ("roll", xor_gather_roll)]:
            print(f"xor1 {name}    "
                  f"{bench(jax.jit(xg), a, g)*1e3:8.2f} ms")
            print(f"mc_vec {name}  "
                  f"{bench(jax.jit(mc_vec(xg)), a, bv, bg)*1e3:8.2f} ms")
            print(f"mc_scan {name} "
                  f"{bench(jax.jit(mc_scan(xg)), a, bv, bg)*1e3:8.2f} ms")

        # rotation variants: shared-perm static gather vs per-row gather vs
        # one-hot matmul (bf16)
        shared = jax.jit(lambda x: x[:, perm])
        print(f"rot shared-perm {bench(shared, a)*1e3:8.2f} ms")
        perrow = jax.jit(lambda x, p: jnp.take_along_axis(x, p, axis=-1))
        print(f"rot per-row     {bench(perrow, a, permT)*1e3:8.2f} ms")
        oh = jax.nn.one_hot(perm, q, dtype=jnp.bfloat16)
        mm = jax.jit(lambda x: (x.astype(jnp.bfloat16) @ oh).astype(jnp.float32))
        print(f"rot onehot-mxu  {bench(mm, a)*1e3:8.2f} ms")


if __name__ == "__main__":
    main()
