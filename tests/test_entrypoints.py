"""Entry points that measure the card: they must refuse to run without one,
and they keep JAX's compile cache where the environment says."""
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import pytest

from bayesianfiltering_tpu import config, diagnostics

REPO = Path(__file__).resolve().parent.parent


class TestCompileCache:
    def test_env_var_set_sets_nothing(self, monkeypatch, tmp_path):
        calls = []
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        assert config.enable_compile_cache() == str(tmp_path)
        assert calls == []

    def test_env_var_unset_uses_repo_dir(self, monkeypatch):
        calls = []
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        monkeypatch.setattr(jax.config, "update",
                            lambda *a: calls.append(a))
        path = config.enable_compile_cache()
        assert path == str(REPO / ".jax_cache")
        assert calls == [("jax_compilation_cache_dir", path)]

    def test_cache_dir_is_ignored_by_git(self):
        assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


class TestNoCardNoResult:
    def test_require_gpu_refuses_cpu(self):
        with pytest.raises(SystemExit):
            diagnostics.require_gpu()

    @pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
    def test_script_exits_nonzero_on_cpu(self, script, tmp_path):
        env = dict(os.environ, JAX_PLATFORMS="cpu",
                   JAX_COMPILATION_CACHE_DIR=str(tmp_path / "cache"))
        r = subprocess.run([sys.executable, str(REPO / script)], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
        assert '"metric"' not in r.stdout

    def test_chip_smoke_alone_exits_nonzero(self, tmp_path):
        """In a directory holding chip_smoke.py and nothing else of the
        repo, the script cannot import the package and prints no result."""
        shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env["JAX_PLATFORMS"] = "cpu"
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                           env=env, capture_output=True, text=True,
                           timeout=300)
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
