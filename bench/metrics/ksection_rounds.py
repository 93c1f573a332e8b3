"""k-section rounds a repartition, the mean over the window
(``BalanceResult.ksection_rounds``)."""


def read(ctx):
    r = ctx["counters"].get("ksection_rounds")
    return sum(r) / len(r) if r else None
