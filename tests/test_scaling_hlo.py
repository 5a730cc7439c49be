"""Compile-level regression: the sharded MC step must stay collective-lean.

Multi-device scaling rests on the compiled sharded batch step containing no
cross-device traffic except the s32[5] counter all-reduce.  A sharding
mistake (e.g. a replicated operand that XLA decides to all-gather, or an
accidental axis constraint on the decode state) would silently turn the
embarrassingly-parallel sweep into a bandwidth-bound one; this test catches
that at compile time.
"""
from ems_nbldpc_tpu.decoder.api import DecoderConfig
from ems_nbldpc_tpu.models.code import random_regular
from ems_nbldpc_tpu.parallel.mesh import (collectives, make_mesh,
                                          sharded_batch_step)
from ems_nbldpc_tpu.sim.mc import SimConfig


def test_sharded_step_has_only_counter_allreduces():
    code = random_regular(48, 24, 64, dv=2, seed=1)
    cfg = SimConfig(
        ebn0_db=2.0, frames_per_batch=32, max_frames=32, stop_errors=10**9,
        decoder=DecoderConfig(max_iters=4, schedule="layered", cn="ems",
                              nm=16, offset=0.3),
    )
    step = sharded_batch_step(code, cfg, make_mesh(8))
    found = collectives(step.compiled_hlo())
    assert found, "the counter all-reduce is missing"
    for op, result in found:
        assert op == "all-reduce" and "s32[5]" in result, (op, result)


def test_collectives_parses_gpu_async_pairs():
    hlo = """
  %all-reduce-start = s32[5]{0} all-reduce-start(s32[5]{0} %c), to_apply=%add
  %all-reduce-done = s32[5]{0} all-reduce-done(s32[5]{0} %all-reduce-start)
  %all-gather.3 = f32[8,4]{1,0} all-gather(f32[2,4]{1,0} %x), dimensions={0}
"""
    assert collectives(hlo) == [
        ("all-reduce", "s32[5]{0}"), ("all-reduce", "s32[5]{0}"),
        ("all-gather", "f32[8,4]{1,0}"),
    ]
