"""On the card: the output check's control fails and the program passes, at
the cell's own size (one seed, a short window).  Runs on the chip with
``python -m pytest -q -p no:cacheprovider port_bench/tests -m cuda``."""
import json
import subprocess
import sys

import pytest
import torch

from conftest import ROOT
from harness import registry


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["world90-f32.walk", "world90-bf16.walk"])
def test_control_fails_and_program_passes(card, name):
    out = subprocess.run([sys.executable, "port_bench/control.py", "--workload", name,
                          "--seconds", "4", "--seeds", str(2 ** 31 + 77)],
                         capture_output=True, text=True, timeout=900, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-4000:]
    reading = json.loads(out.stdout.strip().splitlines()[-1])
    limits = registry.workload(name)["limits"]
    assert all(reading["program"][k] <= v for k, v in limits.items()), reading
    assert any(reading["control_reading"][k] > v for k, v in limits.items()), reading
