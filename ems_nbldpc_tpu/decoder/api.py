"""Decoder front-end: configuration + dispatch.

Knobs mirror the reference CLI contract (``NB_LDPC.c:105-111``): iteration
budget, nm truncation, offset, plus this framework's own choices
(schedule, CN backend, dtype).
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp

from .flooding import decode_flooding
from .graph import DeviceGraph
from .layered import decode_layered


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    max_iters: int = 10
    schedule: str = "layered"   # "layered" | "flooding"
    cn: str = "ems"             # "minsum" (dense exact) | "ems" (nm-truncated)
    nm: int = 0                 # 0 -> no truncation (pure min-sum)
    offset: float = 0.3         # saturation offset (reference arg 6)
    nboper: int = 0             # elementary-step candidate budget (reference
    #                             arg 7); 0 = exact top-nm-distinct merge
    #                             (superset of every bubble trajectory).
    #                             Honored by the list-CN path (storage=
    #                             "compressed"); dense paths are budget-free.
    cn_impl: str = "auto"       # elementary-step impl: dense | topk | list
    #                             | auto | bubble | lbubble (the
    #                             last two: EXACT sequential 8-bubble /
    #                             L-bubble emulation at the nboper budget —
    #                             a validation tool, see ops/bubble_cn.py)
    loop: str = "device"        # device (while_loop) | host (jit per iter)
    storage: str = "dense"      # dense | compressed (nm-truncated CtoV)
    # syndrome-CN family parameters (cn="syndrome"); mirrors the reference
    # main's commented setup (NB_LDPC.c:188-200): n_cv=NbOper, trapeze
    # d1/d2/d3, 1000-config cap, bayes combining, presorting.
    syn_ncv: int = 45
    syn_d: tuple = (40, 15, 5)
    syn_shape: str = "trapeze"
    syn_max_configs: int = 1000
    syn_bayes: bool = True
    syn_presort: bool = True
    syn_sat: str = "kth"        # "kth" (syndrome_ems) | "median" (_median)
    dtype: str = "float32"

    def jnp_dtype(self):
        return jnp.dtype(self.dtype)


def decode(code_or_graph, intrinsic, cfg: DecoderConfig):
    """intrinsic: [F, N, q] min-normalized cost tensor.

    Returns (decide [F, N] int32, iters [F] int32, converged [F] bool).
    """
    if cfg.loop not in ("device", "host"):
        # a typo'd loop value would silently select the device while_loop
        raise ValueError(
            f"loop={cfg.loop!r}: expected 'device' or 'host'"
        )
    if cfg.storage not in ("dense", "compressed"):
        raise ValueError(
            f"storage={cfg.storage!r}: expected 'dense' or 'compressed'"
        )
    g = (
        code_or_graph
        if isinstance(code_or_graph, DeviceGraph)
        else DeviceGraph.from_code(code_or_graph)
    )
    intrinsic = intrinsic.astype(cfg.jnp_dtype())
    kw = dict(max_iters=cfg.max_iters, nm=cfg.nm, offset=cfg.offset,
              cn=cfg.cn, cn_impl=cfg.cn_impl, nboper=cfg.nboper)
    if cfg.cn == "syndrome":
        kw["syn"] = dict(
            n_cv=cfg.syn_ncv, d1=cfg.syn_d[0], d2=cfg.syn_d[1],
            d3=cfg.syn_d[2], shape=cfg.syn_shape,
            max_configs=cfg.syn_max_configs, use_bayes=cfg.syn_bayes,
            presort=cfg.syn_presort, sat_rule=cfg.syn_sat,
        )
    if cfg.schedule == "flooding":
        if cfg.storage == "compressed":
            raise ValueError(
                "compressed storage is implemented for the layered "
                "schedule (the big-code path); use schedule='layered'"
            )
        return decode_flooding(g, intrinsic, **kw)
    if cfg.schedule == "layered":
        if cfg.storage == "compressed":
            if cfg.cn_impl == "topk":
                # round-1 path: dense-intermediate CN, compressed storage
                from .layered import decode_layered_compressed

                return decode_layered_compressed(
                    g, intrinsic, cfg.max_iters, nm=cfg.nm,
                    offset=cfg.offset, dtype=cfg.jnp_dtype(),
                )
            # truncated-list EMS (ops/listcn.py) — the fast big-code path
            if cfg.loop == "host":
                from .layered import decode_layered_list_hostloop

                return decode_layered_list_hostloop(
                    g, intrinsic, cfg.max_iters, nm=cfg.nm,
                    offset=cfg.offset, nboper=cfg.nboper,
                    dtype=cfg.jnp_dtype(),
                )
            from .layered import decode_layered_list

            return decode_layered_list(
                g, intrinsic, cfg.max_iters, nm=cfg.nm, offset=cfg.offset,
                nboper=cfg.nboper, dtype=cfg.jnp_dtype(),
            )
        if cfg.loop == "host":
            from .layered import decode_layered_hostloop

            return decode_layered_hostloop(g, intrinsic, **kw)
        return decode_layered(g, intrinsic, **kw)
    raise ValueError(cfg.schedule)
