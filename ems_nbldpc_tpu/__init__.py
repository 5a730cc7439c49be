"""NB-LDPC EMS simulation & decoding framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of the
Lab-STICC/UBS C reference EMS decoder (Lcrypto/EMS-decoder-of-NB-LDPC-codes):
GF(2^m) arithmetic, parity-check loading (KN/UBS/alist), Gaussian-elimination
encoding, AWGN/QAM/APSK channels with intrinsic-LLR demapping, and Extended
Min-Sum message passing (dense and nm-truncated, bubble-check-equivalent)
with flooding and layered schedules — all batched over thousands of frames
per device and sharded over device meshes for Monte-Carlo FER sweeps.
"""

__version__ = "0.1.0"

from . import gf  # noqa: F401
from .decoder.api import DecoderConfig, decode  # noqa: F401
from .models import NBCode  # noqa: F401
from .models.registry import get_code  # noqa: F401
from .sim.mc import MonteCarlo, SimConfig  # noqa: F401
