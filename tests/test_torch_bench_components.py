"""The port's bench_components tool at tiny sizes on the CPU.

Each suite runs with its own host-oracle check (the native library) at a
size the plain versions finish quickly: MSM n = 64, B = 4; NTT 2^6; 16
Poseidon pairs; a depth-4 tree. The configs, units and keys are the JAX
tool's (tools/bench_components.py), plus the port's device_ms, bound_ms,
cold_sec, checked, device and card. A wrong result fails its check, a suite
that raises makes the tool exit 1 while the later suites still run, and
--log writes under build/, never the repository root.
"""

import ctypes
import json
import os

import pytest
import torch

from zerokit_tpu_torch.runtime import native
from zerokit_tpu_torch.tools import bench_components as bc

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_KEYS = {"poseidon": {"sec"}, "tree": {"warm_sec", "cold_sec"}, "msm": {"sec_per_msm"},
            "ntt": {"sec"}}
PORT_KEYS = {"suite", "config", "value", "unit", "device_ms", "bound_ms", "cold_sec",
             "checked", "device", "card"}
TINY = {  # suite -> (call at a tiny size, configs, unit)
    "poseidon": (lambda b: bc.bench_poseidon(b, 4, sizes=(16,)), ["pairs_16"], "hashes/s"),
    "tree": (lambda b: bc.bench_tree(b, 4, depth=4), ["bulk_insert_2e4"], "leaves/s"),
    "msm": (lambda b: bc.bench_msm(b, 6, sizes=(6,)), ["g1_2e6_b4"], "points/s"),
    "ntt": (lambda b: bc.bench_ntt(b, 6, sizes=(6,)), ["fft_2e6", "ifft_2e6"], "elements/s"),
}


@pytest.fixture(autouse=True)
def one_timed_call(monkeypatch):
    monkeypatch.setattr(bc, "ROUNDS", 1)  # the plain versions are slow here


@pytest.mark.parametrize("suite", list(TINY))
def test_suite_checks_against_its_host_oracle(suite):
    b = bc.Bench("cpu")
    call, configs, unit = TINY[suite]
    call(b)
    assert [line["config"] for line in b.lines] == configs
    for line in b.lines:
        assert line["suite"] == suite and line["unit"] == unit
        assert set(line) >= PORT_KEYS | JAX_KEYS[suite]
        assert line["checked"] is True and line["value"] > 0
        # a CPU run names its device and measures nothing on a card
        assert line["device"] == "cpu"
        assert line["card"] is None and line["device_ms"] is None and line["bound_ms"] is None
    if suite == "ntt":
        assert b.lines[0]["native_checked"] is True


def test_suites_configs_and_seeds_are_the_jax_tools():
    with open(os.path.join(REPO, "tools", "bench_components.py")) as f:
        ref = f.read()
    assert f"for log2n in {bc.MSM_LOG2}:" in ref
    assert f"for log2n in {bc.NTT_LOG2}:" in ref
    assert "for n in (1 << 10, 1 << 16, 1 << 20):" in ref and bc.PAIRS == (1 << 10, 1 << 16, 1 << 20)
    assert f"depth = min({bc.TREE_DEPTH}, MAX_LOG2)" in ref
    assert f"B = {bc.MSM_BATCH}" in ref and f"for _ in range({bc.BASE_BLOCK})" in ref
    for seed in (7, 3, 11, 13):
        assert f"default_rng({seed})" in ref
    assert 'os.environ.get("BC_MAX_LOG2", "20")' in ref
    assert list(bc.SUITES) == ["poseidon", "tree", "msm", "ntt"]


def test_max_log2_reads_the_environment(monkeypatch):
    monkeypatch.delenv("BC_MAX_LOG2", raising=False)
    assert bc.max_log2() == 20
    monkeypatch.setenv("BC_MAX_LOG2", "22")
    assert bc.max_log2() == 22


def test_a_wrong_hash_fails_the_check(monkeypatch):
    from zerokit_tpu_torch.hash import poseidon

    real = poseidon.poseidon_hash_pair_mont

    def off_by_one_lane(left, right):
        out = real(left, right).clone()
        out[0, 5] ^= 1
        return out

    monkeypatch.setattr(poseidon, "poseidon_hash_pair_mont", off_by_one_lane)
    with pytest.raises(AssertionError, match="lane 5"):
        TINY["poseidon"][0](bc.Bench("cpu"))


def test_a_wrong_twiddle_where_the_timed_input_repeats_fails_the_check(monkeypatch):
    """At 2^6 with the timed input's period cut to 16, the forward stages
    m = 16 and 32 see a == b there: a wrong twiddle of stage 32 leaves
    that input's fft, and ifft(fft(x)), right. The input that repeats
    nowhere catches it."""
    from zerokit_tpu_torch.ff import ntt_kernels as nk

    real = nk._tail_tw

    def wrong_stage_32(n, inverse, device, p=nk.TAIL):
        tw = real(n, inverse, device, p)
        if n == 64 and not inverse:
            tw = tw.clone()
            tw[:, 33] = tw[:, 34]  # slot [32, 64) holds stage 32's twiddles
        return tw

    monkeypatch.setattr(bc, "VALUE_BLOCK", 16)
    monkeypatch.setattr(nk, "_tail_tw", wrong_stage_32)
    from zerokit_tpu_torch.groth16 import ntt

    x = bc.FR.encode(list(range(1, 17)) * 4).reshape(16, 1, 64)
    assert torch.equal(ntt.ifft(ntt.fft(x)), x)  # the periodic input cannot see it
    assert torch.equal(ntt.fft(x), ntt.natural_ntt_plain(x, False))
    assert not bc.check_ntt(64, "cpu", with_native=False)
    with pytest.raises(AssertionError, match="fft_2e6"):
        TINY["ntt"][0](bc.Bench("cpu"))


def test_a_failed_suite_exits_1_and_the_later_suites_run(monkeypatch, capsys):
    def boom(b, limit):
        raise RuntimeError("suite fault")

    monkeypatch.setitem(bc.SUITES, "poseidon", boom)
    monkeypatch.setitem(bc.SUITES, "tree", lambda b, limit: bc.bench_tree(b, limit, depth=4))
    assert bc.main(["tree", "poseidon", "--device", "cpu"]) == 1
    out, err = capsys.readouterr()
    assert "suite poseidon FAILED: RuntimeError: suite fault" in err
    lines = [json.loads(s) for s in out.splitlines() if s.startswith("{")]
    assert [line["config"] for line in lines] == ["bulk_insert_2e4"]
    assert bc.main(["tree", "--device", "cpu"]) == 0


def test_unknown_suite_is_an_error():
    with pytest.raises(SystemExit):
        bc.main(["fft", "--device", "cpu"])


def test_log_appends_under_build(tmp_path, monkeypatch):
    assert bc.LOG_PATH == os.path.join(REPO, "build", "zerokit_tpu_torch", "BENCHLOG.jsonl")
    monkeypatch.setitem(bc.SUITES, "ntt", lambda b, limit: bc.bench_ntt(b, limit, sizes=(4,)))
    path = tmp_path / "BENCHLOG.jsonl"
    for _ in range(2):
        b, failed = bc.run(["ntt"], "cpu", log_path=str(path))
        assert failed == []
    logged = [json.loads(s) for s in path.read_text().splitlines()]
    assert [line["config"] for line in logged] == ["fft_2e4", "ifft_2e4"] * 2


def test_fr_ntt_native_copies_its_buffer_once(monkeypatch):
    """fr_ntt_native read `buf.raw`, a copy of the whole buffer, once per
    output value: quadratic, 13 s at 2^16 and out of reach at 2^20. It
    now copies once; its values equal the port's plain NTT."""
    if not native.available():
        pytest.skip("the native host library is not built")
    from zerokit_tpu_torch.constants import R
    from zerokit_tpu_torch.ff.field import FR
    from zerokit_tpu_torch.groth16.ntt import natural_ntt_plain

    reads = []
    real = ctypes.create_string_buffer

    def counted(init):
        class Buffer(type(real(init))):
            pass

        raw = Buffer.raw  # the array type sets its own getter on the class

        def read(self):
            reads.append(1)
            return raw.__get__(self)

        Buffer.raw = property(read)
        buf = Buffer()
        ctypes.memmove(buf, init, len(init))
        return buf

    monkeypatch.setattr(native.ctypes, "create_string_buffer", counted)
    vals = [pow(7, i, R) for i in range(16)]
    got = native.fr_ntt_native(vals)
    monkeypatch.undo()
    assert len(reads) == 1
    want = natural_ntt_plain(FR.encode(vals).reshape(16, 1, 16), False)
    assert [int(v) for v in FR.decode(want.reshape(16, 16))] == got
