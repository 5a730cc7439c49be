"""FER-curve runs for the five BASELINE.json evaluation configs.

Usage:  python benchmarks/fer_curves.py [config_index ...]
Writes results to ./data/ (text + JSONL).  Heavy: run on the GPU.
"""
import sys

sys.path.insert(0, ".")

from ems_nbldpc_tpu.decoder.api import DecoderConfig  # noqa: E402
from ems_nbldpc_tpu.models import registry  # noqa: E402
from ems_nbldpc_tpu.sim.mc import SimConfig  # noqa: E402
from ems_nbldpc_tpu.sim.sweep import run_sweep  # noqa: E402

CONFIGS = [
    # 1: short code, flooding EMS, one Eb/N0 (CPU-runnable)
    dict(matrix="Mat24_N48_M24", grid=[2.0],
         dec=dict(schedule="flooding", cn="ems", nm=16, offset=0.3,
                  max_iters=20), batch=2048),
    # 2: N96_K48_GF64 bubble-check CN, Eb/N0 grid
    dict(matrix="N96_K48_GF64", grid=[3.0, 3.5, 4.0, 4.5],
         dec=dict(schedule="layered", cn="ems", nm=24, offset=0.3,
                  max_iters=10), batch=4096),
    # 3: irregular-profile code, layered + early termination (the C
    # waterfall sits at 3.0-3.5 dB: FER 0.31 @3.0, 7.5e-4 @3.5)
    dict(matrix="Mat212_N480_M80", grid=[3.0, 3.25, 3.5],
         dec=dict(schedule="layered", cn="ems", nm=25, offset=0.0,
                  max_iters=10), batch=2048),
    # 4: DVB-T2-size GF(256), compressed storage, host loop
    dict(matrix="Declercq_64800_R12_GF256", grid=[1.4, 1.6, 1.8],
         dec=dict(schedule="layered", cn="ems", nm=32, offset=0.3,
                  max_iters=10, storage="compressed", dtype="bfloat16"),
         batch=32, encode="zero"),
    # 5: high-rate GF(256) sweep (shard with --devices via cli for
    # multi-chip; single-chip here)
    # (C waterfall: FER 0.7 @3.7, 0.05 @3.8, <0.02 @4.0)
    dict(matrix="Ahmed_64800_R910_GF256", grid=[3.7, 3.8, 4.0],
         dec=dict(schedule="layered", cn="ems", nm=32, offset=0.3,
                  max_iters=10, storage="compressed", dtype="bfloat16"),
         batch=32, encode="zero"),
]


def main(indices):
    for i in indices:
        c = CONFIGS[i]
        code = registry.get_code(c["matrix"])
        base = SimConfig(
            ebn0_db=0.0, frames_per_batch=c["batch"],
            max_frames=200_000, stop_errors=100,
            encode=c.get("encode", "device"),
            decoder=DecoderConfig(**c["dec"]),
        )
        print(f"== config {i}: {c['matrix']} ==")
        run_sweep(code, c["grid"], base, out_dir="./data", verbose=True)


if __name__ == "__main__":
    idx = [int(a) for a in sys.argv[1:]] or list(range(len(CONFIGS)))
    main(idx)
