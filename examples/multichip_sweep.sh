#!/bin/bash
# Frames sharded over 4 devices (one s32[5] psum of the counters per batch).
# On a CPU host this exercises the same program on a virtual mesh:
#   JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=4
ALIST=data/codes/rand_N48_M24_GF64.alist
[ -f "$ALIST" ] || python -c "from ems_nbldpc_tpu.models.tools import \
write_generated_alist as w; w('$ALIST', 48, 24, 64)"
python -m ems_nbldpc_tpu.cli --matrix "$ALIST" --ebn0 1.5:2.5:0.5 \
    --iters 10 --nm 16 --batch 512 --devices 4 --out ./data
