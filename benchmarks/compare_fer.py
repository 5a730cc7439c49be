"""Compare FER curves: framework results.jsonl vs C reference result files.

Usage:
    python benchmarks/compare_fer.py benchmarks/results_r1
Prints, per code, a per-Eb/N0 table with Wilson CIs and an overlap verdict.
C reference files are named c_reference_<codename>.txt; framework rows come
from results.jsonl (matched on the code name).
"""
import glob
import json
import os
import re
import sys

sys.path.insert(0, ".")

from ems_nbldpc_tpu.utils.stats import overlapping, wilson_ci  # noqa: E402


def parse_c_results(path):
    out = {}
    for line in open(path):
        m = re.search(r"SNR:([\d.]+): \s*FER= (\d+) / (\d+)", line)
        if m:
            out[float(m.group(1))] = (int(m.group(2)), int(m.group(3)))
    return out


def load_mine(dirpath):
    mine = {}
    jsonl = os.path.join(dirpath, "results.jsonl")
    if os.path.exists(jsonl):
        for line in open(jsonl):
            r = json.loads(line)
            name = os.path.basename(r["code"]).replace(".txt", "")
            mine.setdefault(name, {})[round(r["ebn0_db"], 4)] = (
                r["frame_errors"], r["frames"]
            )
    return mine


def main(dirpath):
    mine = load_mine(dirpath)
    for f in sorted(glob.glob(os.path.join(dirpath, "c_reference_*.txt"))):
        cname = re.sub(r"^c_reference_|\.txt$", "", os.path.basename(f))
        c_points = parse_c_results(f)
        m_points = mine.get(cname, {})
        print(f"== {cname} ==")
        print(f"{'Eb/N0':>6} {'C FER':>10} {'JAX FER':>10} "
              f"{'C CI':>20} {'JAX CI':>20}  overlap")
        for ebn0 in sorted(set(c_points) | set(m_points)):
            c = c_points.get(ebn0)
            m = m_points.get(ebn0)
            cf = f"{c[0]/c[1]:.4g}" if c else "-"
            mf = f"{m[0]/m[1]:.4g}" if m else "-"
            cci = "[%.3g,%.3g]" % wilson_ci(*c) if c else "-"
            mci = "[%.3g,%.3g]" % wilson_ci(*m) if m else "-"
            ok = overlapping(*c, *m) if (c and m) else None
            print(f"{ebn0:6.2f} {cf:>10} {mf:>10} {cci:>20} {mci:>20}  "
                  f"{'YES' if ok else '-' if ok is None else 'NO'}")
        print()


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "benchmarks/results_r1")
