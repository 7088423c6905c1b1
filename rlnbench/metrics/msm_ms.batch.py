"""Milliseconds a call spends in the five MSMs (K2, K3): stages msm_ab1l, msm_b2 and msm_h, summed over their passes.

Read from the program's own stage timers (runtime/profiling.PipelineMetrics,
through generate_proofs' metrics= argument: a host clock that ends each
stage in torch.cuda.synchronize()), over the window's calls. None where the
window holds no call or the program names no such stage."""

STAGES = ("msm_ab1l", "msm_b2", "msm_h")


def read(ctx):
    calls = ctx.get("calls") or []
    if not calls or not all(any(s in c["stages"] for s in STAGES) for c in calls):
        return None
    return 1e3 * sum(sum(c["stages"].get(s, 0.0) for s in STAGES) for c in calls) / len(calls)
