#!/usr/bin/env python
"""Benchmark: one JSON line with the headline metric, measured on a GPU.

Headline: full-chain Monte-Carlo throughput (source -> bit-matmul encode ->
BPSK-AWGN -> demap -> layered decode -> error accounting) on the generated
DVB-T2-size code rand_N8100_M4050_GF256 (``random_regular(8100, 4050, 256,
dv=2, seed=1)``: 64800 bits, R=1/2, dv=2, dc=4) at Eb/N0 = 1.8 dB.

Two decoders, each one warm-up run (compile) then one measured run of two
batches of 128 frames:

* the exact sum-product check node via Walsh-Hadamard matmuls (layered,
  host loop, dense f32 messages) — the headline value;
* the truncated-list EMS at the C reference's own operating point (nm=32,
  offset=0.3, nbOper=64, 10 iterations, bf16 compressed messages).

Runs in this process; a failure raises and exits non-zero.  Without a GPU
it exits non-zero and prints nothing on stdout.
"""
import json
import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
SHAPE = dict(n=8100, m=4050, q=256, dv=2, seed=1)
EBN0 = 1.8
FRAMES_PER_BATCH = 128


def measure(code, decoder):
    from ems_nbldpc_tpu.sim.mc import MonteCarlo, SimConfig

    cfg = SimConfig(ebn0_db=EBN0, frames_per_batch=FRAMES_PER_BATCH,
                    max_frames=2 * FRAMES_PER_BATCH, stop_errors=10**9,
                    decoder=decoder)
    mc = MonteCarlo(code, cfg)
    mc.run()  # warm-up + compile
    return mc.run()


def main() -> int:
    sys.path.insert(0, HERE)
    from ems_nbldpc_tpu.decoder.api import DecoderConfig
    from ems_nbldpc_tpu.models.code import random_regular
    from ems_nbldpc_tpu.utils.cache import enable_compile_cache
    from ems_nbldpc_tpu.utils.device import card_info, require_gpu

    devs = require_gpu()
    enable_compile_cache()
    code = random_regular(**SHAPE)
    spa = measure(code, DecoderConfig(
        max_iters=20, schedule="layered", cn="spa", nm=0, loop="host",
        storage="dense", dtype="float32"))
    ems = measure(code, DecoderConfig(
        max_iters=10, schedule="layered", cn="ems", nm=32, offset=0.3,
        nboper=64, loop="host", storage="compressed", dtype="bfloat16"))
    result = {
        "metric": f"frames/s full MC chain, {code.name} (DVB-T2 size, "
                  f"GF(256), R=1/2) layered WHT-SPA @{EBN0}dB, 1 GPU",
        "value": round(spa.frames_per_s, 2),
        "unit": "frames/s",
        "extra": {
            "card": card_info(),
            "device": f"{devs[0].platform}:{devs[0].device_kind}",
            "fer": spa.fer,
            "avg_iters": round(spa.avg_iters, 3),
            "info_mbps": round(spa.info_mbps, 3),
            "frames_per_batch": FRAMES_PER_BATCH,
            "ems_frames_per_s": round(ems.frames_per_s, 2),
            "ems_fer": ems.fer,
            "ems_avg_iters": round(ems.avg_iters, 3),
            "ems_decoder": "truncated-list EMS nm=32 nbOper=64 bf16 "
                           "compressed (ops/listcn.py)",
        },
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
