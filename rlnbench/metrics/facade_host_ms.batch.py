"""Milliseconds a call spends in the facade outside the prover's stages:
each RLN.generate_proofs call's wall clock (the benchmark's host clock)
less the sum of all its PipelineMetrics stages (witness validation, the
public values on the host, the named inputs, the padding), averaged over
the window's calls. None where the window holds no call or a call
recorded no stage."""


def read(ctx):
    calls = ctx.get("calls") or []
    if not calls or not all(c["stages"] for c in calls):
        return None
    return 1e3 * sum(c["wall_s"] - sum(c["stages"].values()) for c in calls) / len(calls)
