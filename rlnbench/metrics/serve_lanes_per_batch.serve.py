"""Witnesses a device batch of the prover service over the window: the
growth of ProverService.total_proofs over that of total_batches (the
service's own counters, read before and after the window). None where the
window saw no batch."""


def read(ctx):
    counters = ctx.get("counters") or {}
    if not counters.get("total_batches"):
        return None
    return counters["total_proofs"] / counters["total_batches"]
