"""between_steps_ms: from one train step's end to the next one's start (the
feed's gather and the caller's loop), ms a step on the device clock
(perfbench/spans.py)."""

from perfbench.spans import between_steps_ms


def read(ctx):
    return between_steps_ms(ctx)
