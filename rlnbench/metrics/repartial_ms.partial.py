"""Milliseconds a window call spends making partial proofs again, averaged
over every call of the window: stages partial_witness (the members'
witnesses on the card) and partial_msm (the known wires' MSMs), which run
only in the calls whose lanes' root epoch has no partial held yet (one call
in root_every / batch).

Read from the program's own stage timers (runtime/profiling.PipelineMetrics,
through generate_partial_proofs' metrics= argument), over the window's
calls. None where the window holds no call or no call of it names such a
stage (a program without partial proofs)."""

STAGES = ("partial_witness", "partial_msm")


def read(ctx):
    calls = ctx.get("calls") or []
    if not any(s in c["stages"] for c in calls for s in STAGES):
        return None
    return 1e3 * sum(sum(c["stages"].get(s, 0.0) for s in STAGES) for c in calls) / len(calls)
