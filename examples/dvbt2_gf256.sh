#!/bin/bash
# DVB-T2-size GF(256) R=1/2 sweep with the nm-compressed bf16 decoder, on
# the generated stand-in code rand_N8100_M4050_GF256 (64800 bits, dv=2,
# dc=4; random_regular(8100, 4050, 256, dv=2, seed=1)).
ALIST=data/codes/rand_N8100_M4050_GF256.alist
[ -f "$ALIST" ] || python -c "from ems_nbldpc_tpu.models.tools import \
write_generated_alist as w; w('$ALIST', 8100, 4050, 256)"
python -m ems_nbldpc_tpu.cli --matrix "$ALIST" \
    --ebn0 1.4:2.0:0.2 --iters 10 --nm 32 --offset 0.3 --nboper 64 \
    --storage compressed --dtype bfloat16 --batch 128 \
    --stop-errors 40 --out ./data
