"""The finish's MSMs' share of their roofline in the traced calls: the least
time of the MSM work those calls needed, over the device time inside the
program's msm.* ranges.

The traced calls finish only (their lanes' partial proofs are held), so
the work is the finish's: the bucket method's Montgomery products
(yardstick: c = 8, 32 windows, each query's finite points a lane as the
configuration counts them, the unknown wires' of a, b1, b2 (Fq2 products)
and l, and all of h) for every proof the traced calls returned, at 264
32-bit multiplies a product, over the card's multiply peak (SMs x maximum
SM clock x 64 a clock). None without a trace or without msm.* ranges on
the device's timeline."""

from rlnbench import yardstick


def read(ctx):
    trace, chip = ctx.get("trace"), ctx.get("chip")
    if not trace or not chip or not trace["ranges_s"].get("msm."):
        return None
    imads = trace["lanes"] * yardstick.proof_msm_imads(ctx["config"]["msm_points"])
    least_s = imads / yardstick.imad_peak_per_s(chip["sm_count"], chip["clock_max_mhz"])
    return 100.0 * least_s / trace["ranges_s"]["msm."]
