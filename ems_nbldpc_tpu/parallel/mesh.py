"""Multi-device Monte-Carlo: frames sharded over a 1-D device mesh.

The reference scales out by forking one OS process per SNR point
(``/root/reference/start.sh:18-22``) with no inter-process communication.
Here (SURVEY.md §2.5) frames are i.i.d., so the frame axis shards perfectly
over a ``jax.sharding.Mesh``; per-batch error counters are reduced with one
``psum`` and only five scalars ever reach the host, where the
stop-at-K-errors rule runs.  The cards of one host are joined all to all,
so a single ``frames`` axis covers them.
"""
from __future__ import annotations

import re

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..models.code import NBCode
from ..sim.mc import SimConfig, make_batch_step

COLLECTIVE = re.compile(
    r"= (.*?) (all-reduce|all-gather|reduce-scatter|collective-permute"
    r"|all-to-all)(-start|-done)?(\.\d+)?\("
)


def collectives(hlo: str) -> list:
    """(op, result type) of every collective in compiled HLO text; the
    GPU's async ``-start``/``-done`` pairs count as their op.

    The sharded step is meant to hold exactly one kind: the ``s32[5]``
    counter all-reduce (tests/test_scaling_hlo.py, ``chip_smoke --four``).
    """
    return [(m.group(2), m.group(1)) for m in COLLECTIVE.finditer(hlo)]


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D frame-sharding mesh over the available (or given) devices."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            if len(devices) < n_devices:
                raise ValueError(
                    f"requested a {n_devices}-device mesh but only "
                    f"{len(devices)} {devices[0].platform} device(s) are "
                    "visible (for a virtual CPU mesh set XLA_FLAGS="
                    f"--xla_force_host_platform_device_count={n_devices} "
                    "AND jax.config.update('jax_platforms','cpu') before "
                    "first jax use)"
                )
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), axis_names=("frames",))


def _shardable(cfg: SimConfig) -> SimConfig:
    """Rewrite a decoder config into its jittable device-loop equivalent.

    ``loop="host"`` and the legacy ``storage="compressed"``+``cn_impl=
    "topk"`` stepper drive the decode from the host one iteration at a
    time; under ``shard_map`` the same decode runs as a ``while_loop``
    (``decode_layered`` / ``decode_layered_list``) with identical
    semantics, so sharding just switches the loop style.

    The rewrite is announced with a UserWarning: the replacement paths are
    argued-equivalent but not bit-identical (e.g. the legacy topk stepper
    computes f32 top_k where the list CN uses bf16 packed-key sorts), so a
    user A/B-ing "the same config" sharded vs not should know the decoder
    implementation changed underneath.
    """
    import dataclasses
    import warnings

    d = cfg.decoder
    repl = {}
    if d.loop == "host":
        repl["loop"] = "device"
    if d.storage == "compressed" and d.cn_impl == "topk":
        repl["cn_impl"] = "auto"   # list path: the shardable compressed CN
    if repl:
        warnings.warn(
            f"sharded execution rewrote decoder config {repl} (host control "
            "flow cannot live under shard_map); semantics are equivalent "
            "but numerics may differ slightly from the unsharded run",
            stacklevel=3,
        )
        cfg = dataclasses.replace(cfg, decoder=dataclasses.replace(d, **repl))
    return cfg


def sharded_batch_step(code: NBCode, cfg: SimConfig, mesh: Mesh):
    """Build a jitted step: (key, ebn0_db) -> global counters [5].

    ``cfg.frames_per_batch`` is the *per-device* batch; each device draws an
    independent PRNG stream by folding in its mesh position.  Eb/N0 is a
    traced argument (one compile per code/config across a whole sweep,
    matching the single-device path, sim.mc.MonteCarlo).
    """
    step, enc = make_batch_step(code, _shardable(cfg))
    n_dev = mesh.devices.size
    # the generator bit-matrix is an argument, replicated once: closed over,
    # it would be embedded in the program as a constant (1 GB at DVB-T2 size)
    pmat = jax.device_put(step.pmat, NamedSharding(mesh, P()))

    def device_step(key, ebn0, pmat):
        # distinct stream per mesh position
        idx = jax.lax.axis_index("frames")
        counters, _ = step(jax.random.fold_in(key, idx), ebn0, pmat)
        # psum makes every device hold the global totals; the varying cast
        # lets the replicated result be returned as stacked per-device rows
        # under full vma checking (check_vma=False was observed to
        # intermittently DROP the psum on the virtual CPU mesh — silent
        # wrong counters)
        tot = jax.lax.psum(counters, axis_name="frames")
        return jax.lax.pcast(tot, ("frames",), to="varying")[None]

    fn = jax.shard_map(
        device_step,
        mesh=mesh,
        in_specs=(P(), P(), P()),  # same key everywhere; fold_in differs
        out_specs=P("frames"),
    )
    jitted = jax.jit(fn)

    def run_step(key, ebn0=None):
        e = jnp.float32(cfg.ebn0_db if ebn0 is None else ebn0)
        return jitted(key, e, pmat)[0]

    def compiled_hlo():
        key = jax.random.PRNGKey(0)
        e = jnp.float32(cfg.ebn0_db)
        return jitted.lower(key, e, pmat).compile().as_text()

    run_step.n_devices = n_dev
    run_step.encoder = enc
    run_step.compiled_hlo = compiled_hlo
    return run_step


def run_sharded(code: NBCode, cfg: SimConfig, mesh: Mesh,
                verbose: bool = False, step=None):
    """Monte-Carlo loop over the mesh; mirrors sim.mc.MonteCarlo.run.

    Pass a prebuilt ``step`` (from :func:`sharded_batch_step`) to reuse one
    compile across the SNR points of a sweep — Eb/N0 is traced.
    """
    from ..sim.mc import run_batches

    if step is None:
        step = sharded_batch_step(code, cfg, mesh)
    return run_batches(step, code, cfg, verbose=verbose)
