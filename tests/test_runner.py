"""Runner tooling tests (the pywaiwera analogue, waiwera_tpu/runner.py;
mirrors the spirit of utils/pywaiwera/test — argument handling and a
real run through the programmatic entry point).
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from waiwera_tpu import runner


def test_version_string():
    v = runner.get_pkg_version()
    assert isinstance(v, str) and v.count(".") >= 1


def test_main_version_flag(capsys):
    assert runner.main(["--version"]) == 0
    out = capsys.readouterr().out.strip()
    assert out == runner.get_pkg_version()


def test_main_requires_filename(capsys):
    # no filename: help + nonzero exit (waiwera-dkr prints usage)
    assert runner.main([]) == 1
    assert "FILENAME" in capsys.readouterr().out


def test_run_waiwera_end_to_end(tmp_path, monkeypatch):
    """run_waiwera drives the CLI: a 3-cell eos_w column for two fixed
    steps, HDF5 + YAML log in cwd (DockerEnv.run_waiwera analogue,
    pywaiwera/docker.py:538-614)."""
    config = {
        "mesh": {"type": "column", "dz": [5.0, 5.0, 5.0]},
        "eos": {"name": "w", "temperature": 20.0},
        "initial": {"primary": [1.0e5], "region": 1},
        "output": {"filename": "runner_model.h5"},
        "time": {
            "start": 0.0,
            "step": {"size": 1.0e3, "maximum": {"number": 2}},
        },
    }
    fn = tmp_path / "runner_model.json"
    fn.write_text(json.dumps(config))
    monkeypatch.chdir(tmp_path)
    rc = runner.run_waiwera(str(fn), platform="cpu")
    assert rc == 0
    with h5py.File(tmp_path / "runner_model.h5") as f:
        p = np.asarray(f["cell_fields"]["fluid_pressure"])
        assert p.shape[0] >= 1 and p.shape[1] == 3
        assert np.all(np.isfinite(p))
    assert (tmp_path / "runner_model.yaml").exists()


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("from_env", [False, True])
def test_compile_cache_placement(tmp_path, monkeypatch, from_env):
    """The persistent compile cache goes where JAX_COMPILATION_CACHE_DIR
    says, with nothing set in code (JAX reads the variable itself), and
    otherwise to .jax_cache at the root of the checkout, which git
    ignores."""
    import jax
    from waiwera_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        jax.config.update("jax_compilation_cache_dir", None)
        if from_env:
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
            assert compile_cache.enable_compile_cache() == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir is None
        else:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            path = compile_cache.enable_compile_cache()
            assert path == os.path.join(ROOT, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == path
            with open(os.path.join(ROOT, ".gitignore")) as f:
                assert ".jax_cache/" in f.read().split()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_chip_smoke_refuses_cpu():
    """chip_smoke.py exits non-zero, and prints no result line, when
    JAX's first device is not a GPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "needs an NVIDIA GPU" in r.stderr
