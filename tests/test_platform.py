"""Where the program runs: the compile-cache helper, the multichip dryrun's
device checks, and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]

_CACHE_PROBE = """
import jax, jax.numpy as jnp
from tcgan_tpu.run.common import enable_compile_cache
print(enable_compile_cache())
def cache_probe_{tag}(x):
    return jnp.sin(x) * 3.0 + 1.0
jax.block_until_ready(jax.jit(cache_probe_{tag})(jnp.arange(7.0)))
"""


def _run_cache_probe(tag, extra_env):
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": str(ROOT),
           # persist even a millisecond compile
           "JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS": "0"}
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(extra_env)
    out = subprocess.run([sys.executable, "-c", _CACHE_PROBE.format(tag=tag)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    return Path(out.stdout.strip().splitlines()[-1])


def test_compile_cache_honours_env_dir(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the helper sets nothing and the
    cache lands in that directory."""
    used = _run_cache_probe(
        "env", {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)})
    assert used == tmp_path
    assert any("cache_probe_env" in p.name for p in tmp_path.iterdir())


def test_compile_cache_defaults_to_repo_path():
    """Without the variable, the cache lands at <repo>/.jax_cache on every
    backend (here the CPU)."""
    from tcgan_tpu.run.common import COMPILE_CACHE_DIR

    tag = f"default_{os.getpid()}"
    used = _run_cache_probe(tag, {})
    assert used == COMPILE_CACHE_DIR == ROOT / ".jax_cache"
    assert any(f"cache_probe_{tag}" in p.name
               for p in COMPILE_CACHE_DIR.iterdir())


def test_dryrun_multichip_raises_without_enough_devices():
    """Too few devices is an error, never a quiet switch of platform."""
    import __graft_entry__ as g

    with pytest.raises(RuntimeError, match="need 64 devices"):
        g.dryrun_multichip(64)


def test_dryrun_multichip_runs_on_virtual_devices(capsys):
    """The sharded WGAN-GP step on a (2 x 2) mesh of the test session's
    virtual CPU devices takes one finite step."""
    import __graft_entry__ as g

    g.dryrun_multichip(4)
    assert "dryrun_multichip OK" in capsys.readouterr().out


def _smoke(cwd, script):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, str(script)], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_without_gpu():
    out = _smoke(ROOT, ROOT / "chip_smoke.py")
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
    assert "no GPU" in out.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it fails too, and prints no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_text((ROOT / "chip_smoke.py").read_text())
    out = _smoke(tmp_path, script)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout
