"""Milliseconds a call spends in the finish's MSMs (K2, K3): stages msm_finish (the unknown wires' MSMs of a, b1, b2 and l, and the partial sums added on the card) and msm_h, summed over their passes.

Read from the program's own stage timers (runtime/profiling.PipelineMetrics,
through finish_proofs' metrics= argument: a host clock that ends each
stage in torch.cuda.synchronize()), over the window's calls. None where the
window holds no call or the program names no such stage."""

STAGES = ("msm_finish", "msm_h")


def read(ctx):
    calls = ctx.get("calls") or []
    if not calls or not all(any(s in c["stages"] for s in STAGES) for c in calls):
        return None
    return 1e3 * sum(sum(c["stages"].get(s, 0.0) for s in STAGES) for c in calls) / len(calls)
