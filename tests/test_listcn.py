"""Truncated-list EMS CN (ops/listcn.py) — correctness vs brute force and
vs the dense decoder at nm=q (where both are exact)."""
import jax.numpy as jnp
import numpy as np
import pytest

from ems_nbldpc_tpu.models import registry
from ems_nbldpc_tpu.decoder.graph import DeviceGraph
from ems_nbldpc_tpu.golden import list_merge_ref
from ems_nbldpc_tpu.ops.listcn import (
    BIG, expand_list, fb_checknode_list, list_combine, mul_cols,
    neutral_list, rotate_ids, saturate_list,
)


def brute_merge(av, ag, bv, bg, nm):
    """Exact top-nm-distinct merge, scalar reference."""
    best = {}
    for i in range(len(av)):
        for j in range(len(bv)):
            v = av[i] + bv[j]
            if v >= float(BIG):
                continue
            g = int(ag[i]) ^ int(bg[j])
            if g not in best or v < best[g]:
                best[g] = v
    items = sorted(best.items(), key=lambda kv: (kv[1], 0))
    out_v = np.full(nm, float(BIG))
    out_g = np.zeros(nm, np.int64)
    for s, (g, v) in enumerate(items[:nm]):
        out_v[s], out_g[s] = v, g
    return out_v, out_g


@pytest.mark.parametrize("nboper", [0, 12, 40])
def test_list_combine_vs_brute(nboper):
    rng = np.random.default_rng(0)
    nm, q, rows = 8, 64, 17
    av = np.sort(rng.random((rows, nm)).astype(np.float32) * 5, axis=-1)
    bv = np.sort(rng.random((rows, nm)).astype(np.float32) * 5, axis=-1)
    # GF ids: distinct within each list (as produced by top_k over a dense
    # message), some overlap across lists
    ag = np.stack([rng.permutation(q)[:nm] for _ in range(rows)])
    bg = np.stack([rng.permutation(q)[:nm] for _ in range(rows)])
    ov, og = list_combine(
        jnp.asarray(av), jnp.asarray(ag, jnp.int32),
        jnp.asarray(bv), jnp.asarray(bg, jnp.int32), nm, nboper=nboper,
    )
    ov, og = np.asarray(ov), np.asarray(og)
    for r in range(rows):
        if nboper <= 0:
            ev, eg = brute_merge(av[r], ag[r], bv[r], bg[r], nm)
        else:
            ev, eg = list_merge_ref(av[r], ag[r], bv[r], bg[r], nm,
                                    nboper, float(BIG))
        filled = ev < float(BIG) / 2
        np.testing.assert_allclose(ov[r][filled], ev[filled], rtol=1e-5)
        np.testing.assert_array_equal(og[r][filled], eg[filled])
        assert np.all(ov[r][~filled] >= float(BIG) / 2)


def test_list_combine_neutral_identity():
    rng = np.random.default_rng(1)
    nm, q = 8, 64
    av = np.sort(rng.random((5, nm)).astype(np.float32) * 3, axis=-1)
    ag = np.stack([rng.permutation(q)[:nm] for _ in range(5)])
    nv, ng = neutral_list((5,), nm)
    ov, og = list_combine(jnp.asarray(av), jnp.asarray(ag, jnp.int32),
                          nv, ng, nm)
    np.testing.assert_allclose(np.asarray(ov), av, rtol=1e-6)
    np.testing.assert_array_equal(np.asarray(og), ag)


def test_rotate_ids_matches_mul_table():
    code = registry.get_code("Mat24_N48_M24")
    gf = code.gf
    rng = np.random.default_rng(2)
    coefs = rng.integers(1, gf.q, size=(7, 3))
    cols = mul_cols(gf, coefs)
    icols = mul_cols(gf, coefs, inverse=True)
    g = rng.integers(0, gf.q, size=(4, 7, 3, 5))
    rot = np.asarray(rotate_ids(jnp.asarray(g, jnp.int32),
                                jnp.asarray(cols)[None]))
    expect = gf.mul_table[coefs[None, :, :, None], g]
    np.testing.assert_array_equal(rot, expect)
    back = np.asarray(rotate_ids(jnp.asarray(rot), jnp.asarray(icols)[None]))
    np.testing.assert_array_equal(back, g)


def test_fb_list_equals_dense_at_full_width():
    """With nm = q the list CN is exact: expanding its outputs must equal
    the dense F/B min-convolution."""
    from ems_nbldpc_tpu.ops.minconv import fb_checknode_dense, topk_message

    rng = np.random.default_rng(3)
    q, dc, rows = 16, 5, 6
    vr = rng.random((rows, dc, q)).astype(np.float32) * 6
    vr = vr - vr.min(-1, keepdims=True)
    bv, bg = topk_message(jnp.asarray(vr), q)
    ov, og = fb_checknode_list(bv, bg, q)
    sat = jnp.full(ov.shape[:-1], 1e7, jnp.float32)
    dense = np.asarray(expand_list(ov, og, sat, q))
    expect = np.asarray(fb_checknode_dense(jnp.asarray(vr)))
    expect = expect - expect.min(-1, keepdims=True)
    np.testing.assert_allclose(dense, expect, rtol=1e-4, atol=1e-4)


def test_saturate_list_unfilled_tail():
    ov = jnp.asarray([[0.5, 1.5, float(BIG), float(BIG)]])
    ov2, sat = saturate_list(ov, 0.3)
    np.testing.assert_allclose(np.asarray(sat), [1.3], rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ov2), [[0.0, 1.0, 1.3, 1.3]],
                               rtol=1e-6)


def test_decode_list_matches_dense_minsum_at_full_nm():
    """Small-code e2e: list path at nm=q (exact, no budget) must produce
    the same decisions as the dense min-sum layered decoder."""
    import jax

    from ems_nbldpc_tpu.decoder.api import DecoderConfig, decode

    code = registry.get_code("Mat24_N48_M24")
    g = DeviceGraph.from_code(code)
    rng = np.random.default_rng(4)
    f = 8
    intrinsic = rng.random((f, code.n, code.q)).astype(np.float32) * 8
    intrinsic -= intrinsic.min(-1, keepdims=True)
    cfg_dense = DecoderConfig(max_iters=5, schedule="layered", cn="minsum",
                              nm=0, offset=0.0)
    cfg_list = DecoderConfig(max_iters=5, schedule="layered", cn="ems",
                             nm=code.q, offset=0.0, storage="compressed",
                             dtype="float32")
    d1, it1, c1 = decode(g, jnp.asarray(intrinsic), cfg_dense)
    d2, it2, c2 = decode(g, jnp.asarray(intrinsic), cfg_list)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))


def test_decode_list_hostloop_matches_device_loop():
    from ems_nbldpc_tpu.decoder.layered import (
        decode_layered_list, decode_layered_list_hostloop)

    code = registry.get_code("Mat24_N48_M24")
    g = DeviceGraph.from_code(code)
    rng = np.random.default_rng(5)
    intrinsic = jnp.asarray(rng.random((4, code.n, code.q)), jnp.float32) * 8
    d1, it1, c1 = decode_layered_list(g, intrinsic, 4, nm=12, offset=0.3,
                                      dtype=jnp.float32)
    d2, it2, c2 = decode_layered_list_hostloop(g, intrinsic, 4, nm=12,
                                               offset=0.3, dtype=jnp.float32)
    np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
    np.testing.assert_array_equal(np.asarray(it1), np.asarray(it2))


def test_stepper_cache_content_keyed():
    """Regression (round-1 VERDICT weak 6): cache keys must survive a
    graph being rebuilt — and differ for genuinely different codes."""
    from ems_nbldpc_tpu.decoder.layered import _graph_key

    g1 = DeviceGraph.from_code(registry.get_code("Mat24_N48_M24"))
    g1b = DeviceGraph.from_code(registry.get_code("Mat24_N48_M24"))
    g2 = DeviceGraph.from_code(registry.get_code("Mat26_N48_M16"))
    assert _graph_key(g1) == _graph_key(g1b)
    assert _graph_key(g1) != _graph_key(g2)


def test_densecv_variant_matches_compressed():
    """NBLDPC_LIST_DENSECV=1 (dense CtoV storage, one expansion per layer)
    must decode like the compressed stepper: same EMS semantics, only a
    <=1-ulp bf16 sat quantization difference in APP."""
    import os

    from ems_nbldpc_tpu.decoder.layered import decode_layered_list_hostloop

    code = registry.get_code("benchmarks/results_r2/rand48_gf256.ubs")
    g = DeviceGraph.from_code(code)
    rng = np.random.default_rng(7)
    intrinsic = jnp.asarray(rng.random((16, code.n, code.q)), jnp.float32) * 6
    intrinsic = intrinsic - intrinsic.min(axis=-1, keepdims=True)
    kw = dict(max_iters=6, nm=16, offset=0.3, nboper=32, dtype=jnp.bfloat16)
    d1, it1, c1 = decode_layered_list_hostloop(g, intrinsic, **kw)
    os.environ["NBLDPC_LIST_DENSECV"] = "1"
    try:
        d2, it2, c2 = decode_layered_list_hostloop(g, intrinsic, **kw)
    finally:
        del os.environ["NBLDPC_LIST_DENSECV"]
    # decisions may differ on frames still churning at the budget; converged
    # results and iteration counts must agree
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    conv = np.asarray(c1)
    np.testing.assert_array_equal(np.asarray(d1)[conv], np.asarray(d2)[conv])
    assert abs(int(np.asarray(it1).sum()) - int(np.asarray(it2).sum())) <= 2


def test_trunc_topk_variant_is_exact():
    """NBLDPC_LIST_TRUNC=topk (lax.top_k on packed keys) is bit-identical
    to the default packed-key sort."""
    import os

    from ems_nbldpc_tpu.ops.listcn import topk_list

    rng = np.random.default_rng(3)
    x = jnp.asarray(rng.random((5, 7, 64)), jnp.float32) * 10
    v1, g1 = topk_list(x, 12)
    os.environ["NBLDPC_LIST_TRUNC"] = "topk"
    try:
        v2, g2 = topk_list(x, 12)
    finally:
        del os.environ["NBLDPC_LIST_TRUNC"]
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))


def test_cnsel_topk_variant_is_exact():
    """NBLDPC_LIST_CNSEL=topk (top_k for the CN value-major selection) is
    bit-identical to the default sort."""
    import os

    rng = np.random.default_rng(11)
    nm = 8
    av = jnp.asarray(np.sort(rng.random((6, nm)), axis=-1), jnp.float32) * 4
    bv = jnp.asarray(np.sort(rng.random((6, nm)), axis=-1), jnp.float32) * 4
    ag = jnp.asarray(rng.permuted(np.tile(np.arange(16), (6, 1)), axis=1)[:, :nm])
    bg = jnp.asarray(rng.permuted(np.tile(np.arange(16), (6, 1)), axis=1)[:, :nm])
    v1, g1 = list_combine(av, ag, bv, bg, nm, nboper=12)
    os.environ["NBLDPC_LIST_CNSEL"] = "topk"
    try:
        v2, g2 = list_combine(av, ag, bv, bg, nm, nboper=12)
    finally:
        del os.environ["NBLDPC_LIST_CNSEL"]
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))


def test_listsort_flat_variant_is_exact():
    """NBLDPC_LISTSORT=flat (2-D reshape around lax.sort) is bit-identical
    to the native batched sort through the full CN merge."""
    import os

    rng = np.random.default_rng(19)
    nm = 8
    av = jnp.asarray(np.sort(rng.random((3, 6, nm)), axis=-1), jnp.float32) * 4
    bv = jnp.asarray(np.sort(rng.random((3, 6, nm)), axis=-1), jnp.float32) * 4
    ag = jnp.asarray(rng.permuted(np.tile(np.arange(16), (3, 6, 1)), axis=2)[..., :nm])
    bg = jnp.asarray(rng.permuted(np.tile(np.arange(16), (3, 6, 1)), axis=2)[..., :nm])
    v1, g1 = list_combine(av, ag, bv, bg, nm, nboper=12)
    os.environ["NBLDPC_LISTSORT"] = "flat"
    try:
        v2, g2 = list_combine(av, ag, bv, bg, nm, nboper=12)
    finally:
        del os.environ["NBLDPC_LISTSORT"]
    np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(g2))


def test_fb_tree_equals_chain_when_exact():
    """NBLDPC_LIST_FB=tree must equal the chain association whenever no
    truncation loss occurs (nm = q, nboper = 0): the exact
    top-nm-distinct merge is the min-plus convolution, which is
    associative, and integer-valued inputs make float adds exact."""
    import os

    rng = np.random.default_rng(11)
    q, dc, rows = 16, 7, 5
    vals = rng.integers(0, 1 << 16, size=(rows, dc, q)).astype(np.float32)
    vals -= vals.min(-1, keepdims=True)
    from ems_nbldpc_tpu.ops.minconv import topk_message

    bv, bg = topk_message(jnp.asarray(vals), q)
    ov1, og1 = fb_checknode_list(bv, bg, q)
    os.environ["NBLDPC_LIST_FB"] = "tree"
    try:
        ov2, og2 = fb_checknode_list(bv, bg, q)
    finally:
        del os.environ["NBLDPC_LIST_FB"]
    np.testing.assert_array_equal(np.asarray(ov1), np.asarray(ov2))
    np.testing.assert_array_equal(np.asarray(og1), np.asarray(og2))


def test_fb_tree_truncated_output_wellformed_and_decodes():
    """Truncated tree outputs: ascending, distinct GF among filled slots;
    and the e2e tree decode matches the chain decode's FER behavior on a
    real code (same frames, nearly identical decisions)."""
    import os

    import jax

    from ems_nbldpc_tpu.decoder.api import DecoderConfig, decode
    from ems_nbldpc_tpu.models.channels import ChannelSpec, bpsk_awgn, sigma_for

    rng = np.random.default_rng(12)
    bvals = rng.random((6, 12, 24)).astype(np.float32) * 5
    bvals.sort(axis=-1)
    bgs = np.stack([
        rng.permutation(64)[:24] for _ in range(6 * 12)
    ]).reshape(6, 12, 24)
    os.environ["NBLDPC_LIST_FB"] = "tree"
    try:
        ov, og = fb_checknode_list(
            jnp.asarray(bvals), jnp.asarray(bgs), 24, nboper=45
        )
        ov, og = np.asarray(ov), np.asarray(og)
        assert (np.diff(ov, axis=-1) >= 0).all(), "outputs must ascend"
        for idx in np.ndindex(ov.shape[:-1]):
            filled = ov[idx] < float(BIG) / 2
            gs = og[idx][filled]
            assert len(set(gs.tolist())) == len(gs), "duplicate GF"

        # e2e: dc=12 code through the tree path
        code = registry.get_code("Mat212_N96_M16")
        g = DeviceGraph.from_code(code)
        key = jax.random.PRNGKey(0)
        sigma = sigma_for(ChannelSpec(), 3.5, code.rate)
        cw = jnp.zeros((64, code.n), jnp.int32)
        intr, _ = bpsk_awgn(key, cw, code.q, sigma)
        cfg = DecoderConfig(max_iters=10, schedule="layered", cn="ems",
                            nm=30, offset=0.3, nboper=45,
                            storage="compressed", dtype="bfloat16")
        d_tree, _, c_tree = decode(g, intr, cfg)
    finally:
        del os.environ["NBLDPC_LIST_FB"]
    d_chain, _, c_chain = decode(g, intr, cfg)
    fer_tree = float((np.asarray(d_tree) != 0).any(1).mean())
    fer_chain = float((np.asarray(d_chain) != 0).any(1).mean())
    # both associations decode the same regime (within MC slack on 64 frames)
    assert abs(fer_tree - fer_chain) <= 0.1, (fer_tree, fer_chain)


def test_layer_scan_bitwise_matches_unrolled():
    """NBLDPC_LAYER_SCAN=1 (lax.scan over stacked layer plans) must be
    bit-identical to the Python-unrolled sweep — same op sequence, only
    the program structure changes."""
    import os

    from ems_nbldpc_tpu.decoder.layered import (
        _stepper_cache, make_layered_list_stepper)

    code = registry.get_code("Mat212_N96_M16")  # irregular layer sizes
    g = DeviceGraph.from_code(code)
    rng = np.random.default_rng(9)
    intrinsic = jnp.asarray(rng.random((4, code.n, code.q)), jnp.float32) * 8
    outs = {}
    for mode in ("0", "1"):
        os.environ["NBLDPC_LAYER_SCAN"] = mode
        try:
            init_fn, step_fn = make_layered_list_stepper(
                g, nm=16, offset=0.3, nboper=32, dtype=jnp.float32)
            st = init_fn(intrinsic)
            for _ in range(3):
                st = step_fn(st)
            outs[mode] = [np.asarray(x) for x in st]
        finally:
            del os.environ["NBLDPC_LAYER_SCAN"]
    for a, b in zip(outs["0"], outs["1"]):
        np.testing.assert_array_equal(a, b)
