"""The control (the reference in the program's place with every MSM scalar
cut to 248 bits) comes out as not correct, at a size a test run holds: the
depth-10 circuit, a window of one call of 2 (closed) and 16 sampled
replies (open)."""

from rlnbench import control


def test_control_fails_the_closed_check(small_bench):
    man, _, _ = small_bench
    nums = control.control_closed(man.config("rln-v2-depth10"), man.traffic("closed-b2"),
                                  5000000029, 1)
    assert nums["mismatched_proofs"]["value"] == 2
    assert nums["mismatched_values"]["value"] == 0


def test_control_fails_the_open_check(small_bench):
    man, _, _ = small_bench
    nums = control.control_open(man.config("rln-v2-depth10"), man.traffic("open-test"),
                                5000000039, 4.0)
    assert nums["invalid_proofs"]["value"] == 16
    assert nums["mismatched_values"]["value"] == 0
