#!/usr/bin/env python
"""On-card smoke check: the Monte-Carlo chain at DVB-T2 size on one GPU.

    python chip_smoke.py          # phases 0-3 on one card
    python chip_smoke.py --four   # frame-sharded path on 4 cards vs card 0

Phases (one process; every phase runs in it):

0. the device: JAX must see GPUs (no CPU fallback); prints the card's name
   and power limit, and the JAX and CUDA versions.
1. the code: builds ``rand_N8100_M4050_GF256`` (``random_regular(8100,
   4050, 256, dv=2, seed=1)``: 64800 bits, dv=2, dc=4), writes it as an
   alist under ``data/``, checks the Gaussian elimination and the bit
   generator.  Timed as set-up.
2. the full chain through ``cli.main`` on that alist at Eb/N0 = 1.8 dB:
   (a) layered SPA, 20 iterations, batch 128, device loop; (b) the same on
   the host loop; (c) list EMS nm=32 offset=0.3 nbOper=64 bf16 compressed,
   10 iterations, host loop and device loop.  One warm-up batch and two
   more; prints frames, FER with its Wilson CI, avg_it, steady frames/s,
   compile seconds and peak device memory.
3. the check nodes, the demappers, the encoder and the whole decode, each
   against a plain reference at real width (tolerances below, with why).

Every number goes out beside the card's name and power limit.  The last
line of stdout is one JSON object; any failed phase exits non-zero first.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = dict(n=8100, m=4050, q=256, dv=2, seed=1)
# Eb/N0 of the repo's DVB-T2 bench point; the generated code decodes there
# (avg_it ~4.5 on a CPU trial), so no other point is needed.
EBN0 = 1.8
BATCH = 128
BATCHES = 3                 # one warm-up batch + two measured
SPA = ["--cn", "spa", "--schedule", "layered", "--iters", "20"]
EMS = ["--cn", "ems", "--nm", "32", "--offset", "0.3", "--nboper", "64",
       "--storage", "compressed", "--dtype", "bfloat16", "--iters", "10"]
RUNS = {
    "a_spa_device": SPA + ["--loop", "device"],
    "b_spa_host": SPA + ["--loop", "host"],
    "c_ems_host": EMS + ["--loop", "host"],
    "c_ems_device": EMS + ["--loop", "device"],
}

# Phase-3 tolerances, each with its reason.
# SPA check node vs float64 enumeration.  The WHT matmuls run at
# Precision.HIGHEST (true fp32), and the inverse WHT sums q terms with heavy
# cancellation, so every output probability (normalized to sum 1) carries
# an absolute error of ~1e-7: gate all entries on SPA_PROB_ATOL.  In cost
# terms that error is small only while p >> 1e-7: gate costs where the
# float64 cost is <= SPA_COST_CAP (p >= 4.5e-5).  Beyond that fp32 cannot
# resolve the cost at all (a float64 cost of 19.5 came out as 59 on a CPU
# at q=256), so the error at costs <= 20 is reported, not gated.
SPA_PROB_ATOL = 1e-6
SPA_COST_CAP = 10.0
SPA_COST_ATOL = 0.02
# Demappers: costs reach ~50; fp32 keeps ~7 digits, so 1e-3 absolute has
# ample margin, while TF32 (~3 digits) would miss it by an order.
DEMAP_ATOL = 1e-3
# GPU vs CPU decode: a converged frame's decisions must be identical; its
# iteration count may differ by ITER_SLACK, since exp/log and summation
# order differ between the backends in the last bits.
ITER_SLACK = 2


class CompileClock:
    """Seconds JAX spends tracing, lowering and compiling, summed from its
    monitoring events (a persistent-cache hit counts as its load time)."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        import jax

        self.total = 0.0
        jax.monitoring.register_event_duration_secs_listener(self._on)

    def _on(self, event, duration, **_):
        if event in self.EVENTS:
            self.total += duration


def peak_bytes(dev) -> int:
    return int((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))


# ---------------------------------------------------------------- phase 1

def build_code(path: str, n, m, q, dv=2, seed=1, report=print):
    """Generate + write the code; check elimination and bit generator.
    Returns (code, encoder)."""
    from ems_nbldpc_tpu.models.encoder import gaussian_elimination, syndrome_np
    from ems_nbldpc_tpu.models.tools import write_generated_alist

    t0 = time.perf_counter()
    code = write_generated_alist(path, n, m, q, dv=dv, seed=seed)
    t_graph = time.perf_counter() - t0
    enc = gaussian_elimination(code)
    t_ge = time.perf_counter() - t0 - t_graph
    p = enc.bit_generator
    t_bits = time.perf_counter() - t0 - t_graph - t_ge

    mr, k, nb = code.m_rows, code.k, code.logq
    ut = enc.mat_ut
    assert sorted(enc.perm.tolist()) == list(range(code.n)), "perm"
    assert not np.any(np.tril(ut[:, :mr], -1)), "elimination not triangular"
    assert np.all(np.diag(ut[:, :mr]) != 0), "zero pivot"
    assert p.shape == (k * nb, mr * nb), p.shape
    # host-side encode of 8 frames through the bit generator (packed XOR
    # of the generator rows each info bit selects) must satisfy H c = 0
    rng = np.random.default_rng(seed)
    packed = np.packbits(p, axis=1, bitorder="little")
    shifts = np.arange(nb)
    for _ in range(8):
        bits = rng.integers(0, 2, k * nb).astype(bool)
        par = np.unpackbits(
            np.bitwise_xor.reduce(packed[bits], axis=0), bitorder="little"
        )[: mr * nb]
        cw = np.zeros(code.n, np.int64)
        cw[enc.perm[:mr]] = (par.reshape(mr, nb) << shifts).sum(-1)
        cw[enc.perm[mr:]] = (bits.reshape(k, nb) << shifts).sum(-1)
        assert syndrome_np(code, cw) == 0, "bit generator: H c != 0"
    setup = time.perf_counter() - t0
    report(f"phase1 code {code.name}: N={code.n} M={code.m_rows} "
           f"q={code.q} edges={code.n_edges} layers={len(code.layers)}; "
           f"set-up s: graph+alist {t_graph:.1f}, elimination {t_ge:.1f}, "
           f"bit generator {t_bits:.1f}, total {setup:.1f}")
    return code, enc


# ---------------------------------------------------------------- phase 2

def cli_run(label, alist, extra, out_root, clock, dev, report, ebn0=EBN0,
            batch=BATCH, frames=BATCH * BATCHES):
    """One ``cli.main`` run of ``frames`` frames; returns its
    results.jsonl record plus compile seconds, wall seconds and the
    device's peak memory so far."""
    from ems_nbldpc_tpu import cli

    out = os.path.join(out_root, label)
    if os.path.exists(os.path.join(out, "results.jsonl")):
        os.remove(os.path.join(out, "results.jsonl"))
    argv = ["--matrix", alist, "--ebn0", str(ebn0), "--batch", str(batch),
            "--max-frames", str(frames), "--stop-errors", "10000000",
            "--encode", "device", "--out", out, "--quiet"] + extra
    c0 = clock.total
    t0 = time.perf_counter()
    rc = cli.main(argv)
    wall = time.perf_counter() - t0
    assert rc == 0, (label, rc)
    with open(os.path.join(out, "results.jsonl")) as f:
        r = json.loads(f.read().splitlines()[-1])
    r["compile_s"] = clock.total - c0
    r["wall_s"] = wall
    r["peak_bytes"] = peak_bytes(dev)
    lo, hi = r["fer_ci"]
    report(f"{label}: frames={r['frames']} FER={r['fer']:.4g} "
           f"[{lo:.3g}, {hi:.3g}] ({r['frame_errors']} errors) "
           f"avg_it={r['avg_iters']:.3f}/{r['max_iters']} "
           f"steady={r['steady_frames_per_s']:.2f} fr/s "
           f"first_batch={r['first_batch_s']:.1f} s "
           f"compile={r['compile_s']:.1f} s wall={wall:.1f} s "
           f"peak_mem={r['peak_bytes'] / 2**30:.2f} GiB")
    assert not (r["fer"] == 1.0 and r["avg_iters"] >= r["max_iters"]), \
        f"{label}: decoder diverged"
    return r


def check_run(label, r, frames):
    assert r["frames"] == frames, (label, r["frames"], frames)
    assert r["avg_iters"] < r["max_iters"], (label, "avg_it at the cap")
    assert math.isfinite(r["steady_frames_per_s"]), (label, "one batch")


# ---------------------------------------------------------------- phase 3

def draw_channel(code, enc, frames: int, ebn0: float, seed: int):
    """(codewords [F, N], intrinsic [F, N, q]) from the simulator's own
    device encoder + BPSK-AWGN demapper, on the default device."""
    import jax

    from ems_nbldpc_tpu.models.channels import ChannelSpec, simulate
    from ems_nbldpc_tpu.sim.mc import SimConfig, make_codeword_fn

    cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=frames)
    make_codeword, _, pmat = make_codeword_fn(code, cfg, enc)

    @jax.jit
    def gen(key, pmat):
        kinfo, kchan = jax.random.split(key)
        cw = make_codeword(kinfo, pmat)
        return cw, simulate(kchan, cw, code.q, ChannelSpec(), ebn0,
                            code.rate)

    cw, intr = gen(jax.random.PRNGKey(seed), jax.device_put(pmat))
    return np.asarray(cw), np.asarray(intr)


def row_messages(code, intr, rows: int):
    """[F, rows, dc, q] messages of the first ``rows`` check rows, and
    their coefficients [rows, dc]."""
    cols = code.row_cols[:rows]
    return intr[:, cols], code.row_coefs[:rows]


def check_spa(msgs, coefs, gf, report):
    """fb_checknode_spa (rotated inputs) and fb_checknode_spa_fused
    (un-rotated, GF rotations folded into the WHT) vs float64 enumeration.
    Returns the max abs cost error over entries with reference cost <= cap.
    """
    import jax
    import jax.numpy as jnp

    from ems_nbldpc_tpu.decoder.graph import RotationPlan
    from ems_nbldpc_tpu.golden import spa_checknode_ref
    from ems_nbldpc_tpu.ops.fht import fb_checknode_spa, fb_checknode_spa_fused

    f, g, dc, q = msgs.shape
    plan = RotationPlan.build(coefs, gf)
    got_plain = np.asarray(jax.jit(fb_checknode_spa)(jnp.asarray(msgs)))
    got_fused = np.asarray(jax.jit(
        lambda m: fb_checknode_spa_fused(m, plan, gf))(jnp.asarray(msgs)))
    ref_plain = spa_checknode_ref(msgs)
    # fused reference: rotate in (vr[u] = v[h^-1 u]), enumerate, rotate out
    # (out[c] = out_r[h c])
    mul = gf.mul_table
    inv = gf.inv(coefs)
    vr = np.take_along_axis(msgs, mul[inv][None], axis=-1)
    ref_r = spa_checknode_ref(vr)
    ref_fused = np.take_along_axis(ref_r, mul[coefs][None], axis=-1)
    errs = {}
    for name, got, ref in (("spa", got_plain, ref_plain),
                           ("spa_fused", got_fused, ref_fused)):
        dcost = np.abs(got - ref)
        dprob = float(np.abs(_probs(got) - _probs(ref)).max())
        err = float(dcost[ref <= SPA_COST_CAP].max())
        err20 = float(dcost[ref <= 20].max())
        errs[name] = err
        report(f"phase3 {name} CN: rows={f * g} dc={dc} q={q} "
               f"max|dp|={dprob:.3g} (tol {SPA_PROB_ATOL}); "
               f"max|dcost| at cost<={SPA_COST_CAP:g}: {err:.3g} "
               f"(tol {SPA_COST_ATOL}); at cost<=20: {err20:.3g} "
               f"(reported)")
        assert dprob <= SPA_PROB_ATOL and err <= SPA_COST_ATOL, (name, err)
    return errs


def _probs(cost):
    p = np.exp(-np.asarray(cost, np.float64))
    return p / p.sum(axis=-1, keepdims=True)


def check_list(msgs, nm, nboper, report, cpu):
    """fb_checknode_list on the card vs float64/bf16 enumeration and vs the
    same function on the CPU backend: exact agreement on filled slots."""
    import jax
    import jax.numpy as jnp

    from ems_nbldpc_tpu.golden import list_checknode_ref
    from ems_nbldpc_tpu.ops.listcn import BIG, fb_checknode_list, topk_list

    f, g, dc, q = msgs.shape
    x = msgs.reshape(f * g, dc, q)

    def cn(m):
        bv, bg = topk_list(m, nm)
        return (bv, bg) + fb_checknode_list(bv, bg, nm, nboper)

    bv, bg, ov, og = (np.asarray(a) for a in jax.jit(cn)(jnp.asarray(x)))
    cpu_out = jax.jit(cn)(jax.device_put(x, cpu))
    cov, cog = np.asarray(cpu_out[2]), np.asarray(cpu_out[3])
    mism_ref = 0
    for r in range(f * g):
        ev, eg = list_checknode_ref(bv[r], bg[r], nm, nboper, float(BIG))
        filled = ev < float(BIG) / 2
        if not (np.array_equal(ov[r][filled], ev[filled])
                and np.array_equal(og[r][filled], eg[filled])
                and np.all(ov[r][~filled] >= float(BIG) / 2)):
            mism_ref += 1
    same_cpu = np.array_equal(ov, cov) and np.array_equal(og, cog)
    report(f"phase3 list CN: rows={f * g} dc={dc} nm={nm} nboper={nboper} "
           f"rows differing from enumeration={mism_ref} "
           f"bit-identical to CPU backend={same_cpu}")
    assert mism_ref == 0 and same_cpu
    return mism_ref


def check_demappers(report, frames=8, n=2048, seed=0):
    """BPSK, 2-D (64-APSK) and 4-D (256QAM-4D) demappers on the card vs
    NumPy float64, with Rayleigh fades where the model has them."""
    import jax
    import jax.numpy as jnp

    from ems_nbldpc_tpu.models.channels import (bit_matrix, constellation,
                                                constellation_4d, demap_2d,
                                                demap_4d,
                                                intrinsic_from_bpsk)

    rng = np.random.default_rng(seed)
    sigma = 0.8

    def norm(c):
        return c - c.min(axis=-1, keepdims=True)

    errs = {}
    y = rng.normal(0, 1.3, (frames, n, 8)).astype(np.float32)
    got = np.asarray(jax.jit(lambda v: intrinsic_from_bpsk(v, 256, sigma))(
        jnp.asarray(y)))
    tx = 1.0 - 2.0 * bit_matrix(256).astype(np.float64)           # [q, m]
    ref = ((y.astype(np.float64)[..., None, :] - tx) ** 2).sum(-1)
    errs["bpsk"] = float(np.abs(got - norm(ref / (2 * sigma ** 2))).max())
    for name, pts, dim, fn in (
        ("apsk64_2d", constellation("apsk64", 64), 2, demap_2d),
        ("qam256_4d", constellation_4d(), 4, demap_4d),
    ):
        y = rng.normal(0, 1.0, (frames, n, dim)).astype(np.float32)
        att = np.sqrt(-np.log(rng.uniform(1e-6, 1, y.shape))).astype(
            np.float32)
        got = np.asarray(jax.jit(lambda a, b: fn(a, b, jnp.asarray(pts),
                                                 sigma))(y, att))
        d = (y.astype(np.float64)[..., None, :]
             - att.astype(np.float64)[..., None, :] * pts.astype(np.float64))
        ref = (d ** 2).sum(-1) / (2 * sigma ** 2)
        errs[name] = float(np.abs(got - norm(ref)).max())
    report("phase3 demappers max|dcost| vs float64: " + ", ".join(
        f"{k}={v:.3g}" for k, v in errs.items()) + f" (tol {DEMAP_ATOL})")
    assert all(v <= DEMAP_ATOL for v in errs.values()), errs
    return errs


def check_encoder(code, cw, report):
    from ems_nbldpc_tpu.models.encoder import syndrome_np

    bad = int((syndrome_np(code, cw) != 0).sum())
    report(f"phase3 encoder: {len(cw)} device-encoded frames, "
           f"{bad} with H c != 0")
    assert bad == 0
    return bad


def decode_on(code, intr, cfg, device):
    """Decode ``intr`` with ``cfg`` on ``device``: the jitted while_loop
    for the device loop, the host-stepped decoder otherwise."""
    import jax

    from ems_nbldpc_tpu.decoder.api import decode
    from ems_nbldpc_tpu.decoder.graph import DeviceGraph

    g = DeviceGraph.from_code(code)
    x = jax.device_put(intr, device)
    if cfg.loop == "device" and cfg.storage == "dense":
        out = jax.jit(lambda v: decode(g, v, cfg))(x)
    else:
        out = decode(g, x, cfg)
    return tuple(np.asarray(a) for a in out)


def check_gpu_vs_cpu(code, cw, intr, report, cpu, gpu):
    """Configs (a) and (c) on the same 8 frames on both backends."""
    from ems_nbldpc_tpu.decoder.api import DecoderConfig

    k = code.k
    cfgs = {
        "a_spa_device": DecoderConfig(max_iters=20, schedule="layered",
                                      cn="spa"),
        "c_ems_host": DecoderConfig(
            max_iters=10, schedule="layered", cn="ems", nm=32, offset=0.3,
            nboper=64, storage="compressed", dtype="bfloat16", loop="host"),
    }
    out = {}
    for name, cfg in cfgs.items():
        dg, ig, cg = decode_on(code, intr, cfg, gpu)
        dc, ic, cc = decode_on(code, intr, cfg, cpu)
        both = cg & cc
        same = bool(np.array_equal(dg[both], dc[both]))
        fe_g = int((dg[:, :k] != cw[:, :k]).any(1).sum())
        fe_c = int((dc[:, :k] != cw[:, :k]).any(1).sum())
        dit = int(np.abs(ig - ic)[both].max()) if both.any() else 0
        report(f"phase3 {name} GPU vs CPU on {len(cw)} frames: converged "
               f"{int(cg.sum())}/{int(cc.sum())}, decisions identical on "
               f"converged={same}, frame errors {fe_g}/{fe_c}, iters "
               f"{ig.tolist()} vs {ic.tolist()} (max diff {dit}, "
               f"slack {ITER_SLACK})")
        assert same and fe_g == fe_c and dit <= ITER_SLACK, name
        assert np.array_equal(cg, cc), (name, "convergence differs")
        out[name] = dict(same=same, fe=(fe_g, fe_c), max_iter_diff=dit)
    return out


# ---------------------------------------------------------------- --four

def wilson_overlap(a, b) -> bool:
    return a["fer_ci"][0] <= b["fer_ci"][1] and b["fer_ci"][0] <= a["fer_ci"][1]


def avg_it_close(a, b, z: float = 1.96) -> bool:
    """avg_it agree within a 95% bound: iterations lie in [0, cap], so
    each frame's variance is at most cap^2/4 (Popoviciu); the difference
    of two means of n1, n2 frames is within z*cap/2*sqrt(1/n1+1/n2)."""
    cap = a["max_iters"]
    bound = z * cap / 2 * math.sqrt(1 / a["frames"] + 1 / b["frames"])
    return abs(a["avg_iters"] - b["avg_iters"]) <= bound


def four_card_check(code, alist, out_root, clock, report, n_dev=4,
                    batch=BATCH, batches=BATCHES, ebn0=EBN0, runs=None):
    """Configs (a) and (c, device loop) sharded over ``n_dev`` devices
    through ``cli.py --devices`` vs the same configs unsharded on device 0:
    exact frame counts, FER and avg_it within their CIs, and no collective
    in the compiled step but the s32[5] counter all-reduce."""
    import jax

    from ems_nbldpc_tpu.cli import build_parser
    from ems_nbldpc_tpu.decoder.api import DecoderConfig
    from ems_nbldpc_tpu.parallel.mesh import (collectives, make_mesh,
                                              sharded_batch_step)
    from ems_nbldpc_tpu.sim.mc import SimConfig

    dev0 = jax.devices()[0]
    runs = runs or {k: RUNS[k] for k in ("a_spa_device", "c_ems_device")}
    frames = n_dev * batch * batches
    results = {}
    for name, extra in runs.items():
        sharded = cli_run(f"four_{name}", alist,
                          extra + ["--devices", str(n_dev)], out_root, clock,
                          dev0, report, ebn0=ebn0, batch=batch,
                          frames=frames)
        single = cli_run(f"one_{name}", alist, extra, out_root, clock, dev0,
                         report, ebn0=ebn0, batch=batch, frames=frames)
        a = build_parser().parse_args(extra)
        cfg = SimConfig(ebn0_db=ebn0, frames_per_batch=batch,
                        decoder=DecoderConfig(
                            max_iters=a.iters, schedule=a.schedule, cn=a.cn,
                            nm=a.nm, offset=a.offset, nboper=a.nboper,
                            storage=a.storage, loop=a.loop, dtype=a.dtype))
        found = collectives(
            sharded_batch_step(code, cfg, make_mesh(n_dev)).compiled_hlo())
        lean = bool(found) and all(
            op == "all-reduce" and "s32[5]" in t for op, t in found)
        ok = dict(frames=sharded["frames"] == frames == single["frames"],
                  fer=wilson_overlap(sharded, single),
                  avg_it=avg_it_close(sharded, single), collectives=lean)
        report(f"four {name}: {n_dev}-way frames={sharded['frames']} "
               f"vs 1-way frames={single['frames']} (want {frames}); "
               f"steady {sharded['steady_frames_per_s']:.2f} vs "
               f"{single['steady_frames_per_s']:.2f} fr/s; collectives="
               f"{found}; checks={ok}")
        assert all(ok.values()), (name, ok)
        results[name] = dict(sharded=sharded, single=single, checks=ok)
    return results


# ---------------------------------------------------------------- main

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four", action="store_true",
                    help="only the 4-card frame-sharded path and its "
                         "1-card comparison")
    args = ap.parse_args(argv)
    n_dev = 4 if args.four else 1

    # the CPU backend is the phase-3 comparison target: keep it visible
    # beside the GPU when the environment names platforms explicitly
    plats = os.environ.get("JAX_PLATFORMS", "")
    if plats and "cpu" not in plats.split(","):
        os.environ["JAX_PLATFORMS"] = plats + ",cpu"
    sys.path.insert(0, REPO)
    import jax

    from ems_nbldpc_tpu.utils.cache import enable_compile_cache
    from ems_nbldpc_tpu.utils.device import card_info, require_gpu

    t_start = time.perf_counter()
    devs = require_gpu(n_dev)
    enable_compile_cache()
    card = card_info()
    print(card, flush=True)

    def report(msg: str):
        """Every number goes out beside the card's name and power limit."""
        print(f"{msg}  [{card}]", flush=True)

    from jax.extend.backend import get_backend

    report(f"phase0 jax {jax.__version__}, "
           f"{get_backend().platform_version}, {len(devs)} x "
           f"{devs[0].device_kind}")
    clock = CompileClock()
    out_root = os.path.join(REPO, "data", "chip_smoke")
    alist = os.path.join(REPO, "data", "codes",
                         "rand_N{n}_M{m}_GF{q}.alist".format(**FLAGSHIP))
    code, enc = build_code(alist, report=report, **FLAGSHIP)

    if args.four:
        four_card_check(code, alist, out_root, clock, report, n_dev=4)
    else:
        report(f"phase2 Eb/N0 {EBN0} dB (the repo's DVB-T2 bench point, "
               f"where the generated code decodes), batch {BATCH}, "
               f"{BATCHES} batches (1 warm-up)")
        for label, extra in RUNS.items():
            r = cli_run(label, alist, extra, out_root, clock, devs[0],
                        report, batch=BATCH, frames=BATCH * BATCHES)
            check_run(label, r, BATCH * BATCHES)
        cpu = jax.devices("cpu")[0]
        cw, intr = draw_channel(code, enc, 8, EBN0, seed=11)
        msgs, coefs = row_messages(code, intr, 64)
        for name, check in (
            ("spa", lambda: check_spa(msgs, coefs, code.gf, report)),
            ("list", lambda: check_list(msgs, 32, 64, report, cpu)),
            ("demappers", lambda: check_demappers(report)),
            ("encoder", lambda: check_encoder(code, cw, report)),
            ("gpu_vs_cpu", lambda: check_gpu_vs_cpu(code, cw, intr, report,
                                                    cpu, devs[0])),
        ):
            t0 = time.perf_counter()
            check()
            report(f"phase3 {name} took {time.perf_counter() - t0:.1f} s")
    report(f"chip_smoke total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
