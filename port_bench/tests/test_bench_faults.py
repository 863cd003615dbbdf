"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run on the CPU (port_bench.rehearse: the
look for a card skipped, the cell cut to a small size) with one fault
planted where the program produces its output (drivers/*._Fault), and
holds the cell's own limits: a served answer altered, every other image of
a served batch left unrestored, a training step that leaves its state
unchanged, a training step that sees half of its batch. A sound
rehearsal comes out correct. The cells run on one card, so no exchange
between cards can be left out."""

import pytest

from port_bench import rehearse

SERVE = ("promptir-serve-photo", "xrestormer-serve-photo")
TRAIN = ("promptir-train-b24", "xrestormer-train-b24")
# batches of two or more requests, so that a batch's second image exists
LOADED = {"rate_per_s": 30.0, "sample": 6}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in SERVE for f in (
    None, "answer_altered", "half_batch")] + [(c, f) for c in TRAIN for f in (
        None, "unchanged", "half_batch")])
def test_faults_come_out_not_correct(cell, fault):
    traffic = LOADED if cell in SERVE else None
    out = rehearse.rehearse(cell, 2 ** 31 + 11, 1.0, fault=fault,
                            traffic=traffic)
    line = out["line"]
    assert line["correct"] is (fault is None), out["stderr"]
    assert line["attempted"] > 0 and line["failed"] == 0
