"""On the card: one short run of each cell through the measuring command,
its result line whole and correct. Skips without a card."""

import json
import subprocess
import sys

import pytest

from port_bench import manifest

CELLS = [w["name"] for w in manifest.load()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_on_the_card(cell):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures only on the card")
    r = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        cell, "--seed", str(2 ** 31 + 99), "--seconds", "5",
                        "--trace", "0"], cwd=manifest.ROOT, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-3000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1


def test_the_measuring_command_refuses_without_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1"],
                       cwd=manifest.ROOT, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and r.stdout.strip() == ""
