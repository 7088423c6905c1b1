"""The share of the traced window in which the card sat idle while the host
was in the facade: 100 x the seconds of the idle gaps that
yardstick.summarize names by a facade.* range (the program's spans of
RLN.generate_proofs: witness validation, the public values, the named
inputs), over window_s.

The sum runs over the gaps that the breakdown lists, the ten longest by
name, so a facade gap outside them is not counted. None without a trace,
or where no listed gap is a facade.* range (a program without those
spans).

No cell reports it: BENCHMARK.json names it no more, since the facade's
gaps (a few ms a call) fall below the ten that summarize lists and it read
nothing in either cell. The reader stays while a test of the port's spans
(tests/test_torch_tracing.py) rehearses summarize's facade naming through
it, and goes with that test."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    facade = [s for name, s in trace["idle_gaps"] if name.startswith("facade.")]
    if not facade:
        return None
    return 100.0 * sum(facade) / trace["window_s"]
