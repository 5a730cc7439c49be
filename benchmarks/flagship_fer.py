"""Flagship FER check: Declercq_64800_R12_GF256 @1.5 dB vs C anchor.

C reference (essai_ubs `20 10 Declercq_64800_R12_GF256 1.5 32 0.3 64`):
FER = 12/21 = 0.571, avg_it 9.1 (measured r1; Wilson CI [0.37, 0.76]).

Run on the GPU:  python benchmarks/flagship_fer.py [frames]
"""
import sys

sys.path.insert(0, ".")

from ems_nbldpc_tpu.decoder.api import DecoderConfig  # noqa: E402
from ems_nbldpc_tpu.models import registry  # noqa: E402
from ems_nbldpc_tpu.sim.mc import MonteCarlo, SimConfig  # noqa: E402
from ems_nbldpc_tpu.utils.stats import overlapping, wilson_ci  # noqa: E402


def main(frames=64):
    code = registry.get_code("Declercq_64800_R12_GF256")
    cfg = SimConfig(
        ebn0_db=1.5, frames_per_batch=32, max_frames=frames,
        stop_errors=10**9,
        decoder=DecoderConfig(max_iters=10, schedule="layered", cn="ems",
                              nm=32, offset=0.3, storage="compressed",
                              dtype="bfloat16"),
    )
    r = MonteCarlo(code, cfg).run(verbose=True)
    lo, hi = r.fer_ci
    ok = overlapping(r.frame_errors, r.frames, 12, 21)
    print(f"FER={r.fer:.3f} [{lo:.3f},{hi:.3f}] ({r.frame_errors}/{r.frames})"
          f" avg_it={r.avg_iters:.2f}  C: 12/21=0.571 "
          f"{wilson_ci(12, 21)}  overlap={ok}")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 64)
