"""chip_smoke.py: refuses to run off the GPU, and its phases pass on the
CPU backend at a tiny size (the rehearsal of the chip run)."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("where", ["checkout", "alone"])
def test_refuses_without_gpu(where, tmp_path):
    """Exits non-zero with no result on the CPU backend, and in a directory
    that holds chip_smoke.py and nothing else of the repo."""
    script = os.path.join(REPO, "chip_smoke.py")
    if where == "alone":
        script = shutil.copy(script, tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, str(script)],
        cwd=tmp_path,
        env=env,
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


@pytest.mark.parametrize(
    "phase,args",
    [("example", ()), ("pangenome", (4, 20_000)), ("hprc_width", (6, 8192))],
)
def test_phase_on_cpu(phase, args, capsys):
    chip_smoke.run_phase(phase, getattr(chip_smoke, f"phase_{phase}"), "cpu", *args)
    assert f"phase {phase}: wall_s=" in capsys.readouterr().out


def test_four_card_phase_on_four_cpu_devices(tmp_path):
    """The four-card phase on four virtual CPU devices, in a process of its
    own: the CLI's mesh spans every device the process has."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    code = (
        "import jax, chip_smoke; "
        "chip_smoke.run_phase('four_cards', chip_smoke.phase_four_cards, 'cpu', "
        "jax.devices(), 6, 8192)"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code],
        cwd=REPO,
        env=env,
        capture_output=True,
        text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "phase four_cards: wall_s=" in proc.stdout
