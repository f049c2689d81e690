"""The chip-side scripts on the CPU: ``chip_smoke.py`` and the scripts in
``tools/`` fail and print no result where there is no card, and
``chip_smoke.py`` fails too when it stands alone, without the port."""
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def _run(argv, cwd):
    return subprocess.run([sys.executable, *argv], cwd=cwd,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("argv", [
    ["chip_smoke.py"], ["tools/ssm_scan_ablation.py"], ["tools/run_phase.py"],
    ["tools/run_phase.py", "10"], ["tools/run_phase.py", "7"],
    ["tools/run_phase.py", "3"], ["tools/run_phase.py", "seq"],
    ["tools/run_phase.py", "3b"], ["tools/run_phase.py", "4c"],
    ["tools/run_phase.py", "19"], ["tools/run_phase.py", "20"],
    ["tools/run_phase.py", "17"], ["tools/run_phase.py", "18"],
    ["tools/run_phase.py", "22"], ["tools/run_phase.py", "24,25"],
    ["tools/run_phase.py", "35"],
    ["tools/ssm_scan_bwd_ablation.py"],
    ["tools/flash_attention_bwd_ablation.py"],
    ["tools/flash_attention_tf32_ablation.py"],
    ["tools/run_phase.py", "whisper"],
    ["tools/flash_bwd_accuracy.py"], ["tools/flash_bwd_accuracy.py", "model"],
    ["tools/conv_wgrad_layouts.py"]])
def test_tools_fail_without_a_card(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run(argv, ROOT)
    assert proc.returncode != 0
    assert "{" not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], tmp_path)
    assert proc.returncode != 0
    assert "{" not in proc.stdout
