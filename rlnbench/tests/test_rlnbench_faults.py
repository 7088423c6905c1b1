"""A run with the timed path broken underneath comes out as not correct:
the closed loop driven whole on the CPU with a stand-in for the program
(the reference in its place, sound or with a fault planted), and the open
loop's check over replies made the same way. Each fault a cell can have:
half of a batch left out (its lanes answered with the other half's
proofs) and an answer altered where it is produced. The cells run on one
card, so no exchange between cards can be left out."""

import json

import pytest

from rlnbench import check, run
from rlnbench import traffic as gen
from rlnbench.reference import msm
from rlnbench.reference.wire import proof_to_wire
from rlnbench.tests import standins


@pytest.mark.parametrize("program, correct", [
    ("ReferenceProgram", True),
    ("HalfBatchProgram", False),
    ("AlteredAnswerProgram", False),
])
def test_closed_run(small_bench, capsys, program, correct):
    man, _, _ = small_bench
    rc = run.main(["--workload", "v2d10-b2", "--seed", "6000000001", "--seconds", "0.01",
                   "--trace", "0"], make_program=getattr(standins, program), on_card=False,
                  manifest=man)
    assert rc == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["correct"] is correct


@pytest.fixture(scope="module")
def served():
    """Four requests of the depth-10 open cell and the reference's sound
    answers to them."""
    from rlnbench.manifest import HERE

    with open(f"{HERE}/configs/rln-v2-depth20.json") as f:
        config = json.load(f)
    config.update(tree_depth=10, zkey="zerokit_tpu/resources/tree_depth_10/rln_final.arkzkey",
                  graph="zerokit_tpu/resources/tree_depth_10/graph.bin")
    traffic = {"loop": "open", "rate_per_s": 4}
    seed = 6000000011
    due = gen.arrivals(traffic, seed, 1.0)
    requests = [gen.witnesses(config, traffic, seed, "window", i, 1)[0] for i in range(len(due))]
    return config, traffic, seed, requests, standins.ReferenceProgram(config).call(requests)


@pytest.mark.parametrize("fault, correct", [(None, True), ("half", False), ("altered", False),
                                            ("missing", False)])
def test_open_check(served, fault, correct):
    config, traffic, seed, requests, answers = served
    if fault == "half":
        answers = [answers[i % (len(answers) // 2)] for i in range(len(answers))]
    if fault == "altered":
        answers = [((a, b, msm.sum_points([c, (1, 2)])), v) for (a, b, c), v in answers]
    replies = [proof_to_wire(p, v) for p, v in answers]
    if fault == "missing":
        replies[-1] = None
    nums = check.open_loop(config, traffic, seed, requests, replies)
    assert check.report(nums) is correct
