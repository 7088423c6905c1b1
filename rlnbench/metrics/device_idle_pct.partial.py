"""The share of the traced window in which no operation ran on the card:
100 x (1 - busy / window), busy the union of the device events of
torch.profiler's trace inside the window (yardstick.summarize): the
traced calls of the partial cell, which finish only. None without a
trace."""


def read(ctx):
    trace = ctx.get("trace")
    if not trace or trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
