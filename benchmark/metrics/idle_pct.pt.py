"""Share of the profiled stretch in which no kernel, copy or fill ran on
the card, in percent."""

from benchmark.harness.stats import idle_pct


def read(ctx):
    return idle_pct(ctx.trace)
