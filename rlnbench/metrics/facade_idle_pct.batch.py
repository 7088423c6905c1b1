"""The share of the traced window in which the card sat idle while the host
was in the facade: 100 x the seconds of the idle gaps that
yardstick.summarize names by a facade.* range (the program's spans of
RLN.generate_proofs: witness validation, the public values, the named
inputs), over window_s.

The sum runs over the gaps that the breakdown lists, the ten longest by
name, so a facade gap outside them is not counted. None without a trace,
or where no listed gap is a facade.* range (a program without those
spans)."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    facade = [s for name, s in trace["idle_gaps"] if name.startswith("facade.")]
    if not facade:
        return None
    return 100.0 * sum(facade) / trace["window_s"]
