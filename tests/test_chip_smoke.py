"""chip_smoke.py and the compile-cache placement: what can be checked
without a card, plus the bulk step on the card where there is one."""

import os
import subprocess
import sys

import jax
import pytest

from veloslam_tpu.utils import compilecache

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(args):
    return subprocess.run(
        [sys.executable] + args, cwd=REPO, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu"))


def test_device_gate_refuses_cpu():
    import chip_smoke

    with pytest.raises(SystemExit) as e:
        chip_smoke.device_gate()
    assert e.value.code not in (0, None)


def test_smoke_exits_nonzero_without_gpu_and_prints_no_result():
    """Importing the script touches no device; running it on the CPU fails
    at the gate, before any phase, and prints no result line."""
    probe = _run(["-c", "import chip_smoke, jax._src.xla_bridge as xb; "
                        "print(xb.backends_are_initialized())"])
    assert probe.returncode == 0, probe.stderr
    assert probe.stdout.strip() == "False"

    run = _run(["chip_smoke.py"])
    assert run.returncode != 0
    assert '"ok"' not in run.stdout
    assert "need 1 GPU" in run.stderr


@pytest.mark.parametrize("env_dir", [True, False], ids=["env", "checkout"])
def test_compile_cache_placement(monkeypatch, tmp_path, env_dir):
    """JAX_COMPILATION_CACHE_DIR wins and nothing else is configured;
    without it the cache goes to <checkout>/.jax_cache."""
    updates = []
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: updates.append((k, v)))
    if env_dir:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
        assert compilecache.enable() == str(tmp_path)
        assert updates == []
    else:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compilecache.cache_dir() == os.path.join(REPO, ".jax_cache")
        # enable() creates the directory: keep the checkout clean.
        fake = str(tmp_path / ".jax_cache")
        monkeypatch.setattr(compilecache, "DEFAULT_DIR", fake)
        assert compilecache.enable() == fake
        assert updates == [("jax_compilation_cache_dir", fake)]
        assert os.path.isdir(fake)


@pytest.mark.gpu
def test_bulk_step_on_gpu_matches_cpu(gpu_device):
    """The bulk odometry step compiled for the card agrees with the CPU
    (chip_smoke's phase 2 at a reduced batch)."""
    import bench
    import chip_smoke

    _, seq = bench._make_drive(1.3)
    chip_smoke.bulk_phase(gpu_device, jax.devices("cpu")[0], seq,
                          batch_packets=1024, max_frames_batch=12,
                          reg_points=2048, map_capacity=8192,
                          timed_steps=1)
