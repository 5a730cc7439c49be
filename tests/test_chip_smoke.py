"""CPU tests, at tiny size, of what ``chip_smoke.py`` runs on the card:
the generated-code round trip through the CLI, the plain references it
compares against, its GPU-vs-CPU and four-card comparison logic, and its
refusal to run without a GPU."""
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

import chip_smoke
from ems_nbldpc_tpu import cli
from ems_nbldpc_tpu.models.code import load

TINY = dict(n=96, m=48, q=64, dv=2, seed=1)     # dc=4, like the flagship


def _quiet(msg):
    del msg


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("codes") / "tiny.alist")
    code, enc = chip_smoke.build_code(path, report=_quiet, **TINY)
    return code, enc, path


def test_require_gpu_refuses_cpu():
    from ems_nbldpc_tpu.utils.device import require_gpu

    with pytest.raises(SystemExit, match="needs 1 GPU"):
        require_gpu()


def test_main_exits_nonzero_without_gpu(capsys):
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_generated_alist_roundtrips_through_cli(tiny, tmp_path):
    code, _, path = tiny
    back = load(path)
    np.testing.assert_array_equal(back.row_cols, code.row_cols)
    np.testing.assert_array_equal(back.row_coefs, code.row_coefs)
    rc = cli.main(["--matrix", path, "--ebn0", "3.0", "--cn", "spa",
                   "--iters", "8", "--batch", "16", "--max-frames", "48",
                   "--stop-errors", "1000", "--out", str(tmp_path),
                   "--quiet"])
    assert rc == 0
    rec = json.loads((tmp_path / "results.jsonl").read_text().splitlines()[-1])
    assert rec["frames"] == 48 and rec["code"] == path
    assert 0 < rec["avg_iters"] < 8
    assert rec["first_batch_s"] > 0 and rec["steady_frames_per_s"] > 0


def test_spa_checknode_matches_enumeration(tiny):
    code, enc, _ = tiny
    cw, intr = chip_smoke.draw_channel(code, enc, 2, 2.0, seed=3)
    msgs, coefs = chip_smoke.row_messages(code, intr, 16)
    errs = chip_smoke.check_spa(msgs, coefs, code.gf, _quiet)
    assert max(errs.values()) <= chip_smoke.SPA_COST_ATOL


def test_list_checknode_matches_enumeration(tiny):
    code, enc, _ = tiny
    _, intr = chip_smoke.draw_channel(code, enc, 2, 2.0, seed=4)
    msgs, _ = chip_smoke.row_messages(code, intr, 16)
    cpu = jax.devices("cpu")[0]
    assert chip_smoke.check_list(msgs, 16, 40, _quiet, cpu) == 0


def test_demappers_match_float64():
    errs = chip_smoke.check_demappers(_quiet, frames=2, n=64)
    assert set(errs) == {"bpsk", "apsk64_2d", "qam256_4d"}


def test_encoder_and_whole_decode_agree_across_devices(tiny):
    code, enc, _ = tiny
    cw, intr = chip_smoke.draw_channel(code, enc, 8, 3.0, seed=5)
    assert chip_smoke.check_encoder(code, cw, _quiet) == 0
    d0, d1 = jax.devices()[:2]
    out = chip_smoke.check_gpu_vs_cpu(code, cw, intr, _quiet, d0, d1)
    assert all(o["same"] and o["max_iter_diff"] == 0 for o in out.values())


def test_four_card_check_on_virtual_mesh(tiny, tmp_path):
    code, _, path = tiny
    runs = {
        "spa": ["--cn", "spa", "--iters", "6", "--loop", "device"],
        "ems": ["--cn", "ems", "--nm", "16", "--nboper", "32",
                "--storage", "compressed", "--dtype", "bfloat16",
                "--iters", "6", "--loop", "device"],
    }
    res = chip_smoke.four_card_check(
        code, path, str(tmp_path), chip_smoke.CompileClock(), _quiet,
        n_dev=4, batch=8, batches=2, ebn0=3.0, runs=runs)
    for r in res.values():
        assert r["sharded"]["frames"] == r["single"]["frames"] == 64
        assert all(r["checks"].values())


@pytest.mark.parametrize("a_it,b_it,close", [(4.5, 4.6, True),
                                             (4.5, 9.5, False)])
def test_four_card_comparison_rules(a_it, b_it, close):
    a = dict(fer_ci=[0.0, 0.01], avg_iters=a_it, max_iters=20, frames=1536)
    b = dict(fer_ci=[0.005, 0.02], avg_iters=b_it, max_iters=20,
             frames=1536)
    assert chip_smoke.wilson_overlap(a, b)
    assert not chip_smoke.wilson_overlap(a, dict(b, fer_ci=[0.2, 0.3]))
    assert chip_smoke.avg_it_close(a, b) is close


@pytest.mark.parametrize("env", ["", "/elsewhere/jax-cache"])
def test_compile_cache_path(monkeypatch, env):
    from ems_nbldpc_tpu.utils import cache

    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.append((k, v)))
    if env:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert cache.enable_compile_cache() is None
        assert calls == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        path = cache.enable_compile_cache()
        assert path == os.path.join(cache.REPO_ROOT, ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]
    ignored = subprocess.run(["git", "check-ignore", "-q", ".jax_cache/x"],
                             cwd=cache.REPO_ROOT)
    assert ignored.returncode == 0


def test_list_hostloop_after_device_loop_spa_in_one_process():
    """A fresh interpreter runs a device-loop SPA decode, then the list
    host-loop decode.  The list module used to build a module-level jnp
    constant; first imported inside the SPA trace, that constant was a
    leaked tracer, and the later host-loop step then failed with
    "Execution supplied 7 buffers but compiled program expected 97"."""
    prog = """
import jax, jax.numpy as jnp, numpy as np
from ems_nbldpc_tpu.decoder.api import DecoderConfig, decode
from ems_nbldpc_tpu.decoder.graph import DeviceGraph
from ems_nbldpc_tpu.models.code import random_regular
g = DeviceGraph.from_code(random_regular(48, 24, 64, dv=2, seed=1))
x = jnp.asarray(np.random.default_rng(0).random((4, 48, 64), np.float32))
jax.jit(lambda v: decode(g, v, DecoderConfig(max_iters=2, cn="spa")))(x)
d, it, conv = decode(g, x, DecoderConfig(
    max_iters=3, cn="ems", nm=16, nboper=32, storage="compressed",
    loop="host", dtype="bfloat16"))
print("ok", np.asarray(it).tolist())
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, env=env, timeout=300,
                         cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith("ok")


def test_no_module_holds_a_device_array():
    """Module-level jax arrays are created in whatever trace is active at
    first import; the package keeps its constants in NumPy."""
    import importlib
    import pkgutil

    import ems_nbldpc_tpu

    bad = []
    for info in pkgutil.walk_packages(ems_nbldpc_tpu.__path__,
                                      "ems_nbldpc_tpu."):
        mod = importlib.import_module(info.name)
        bad += [f"{info.name}.{k}" for k, v in vars(mod).items()
                if isinstance(v, jax.Array)]
    assert bad == []
