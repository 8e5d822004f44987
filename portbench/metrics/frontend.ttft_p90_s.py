"""The 90th percentile (nearest rank) of every counted request's time
from due to first token, in s; nothing where a counted request never got
one (the run counts it under ``failed``). The tails of first tokens and
of the gaps between tokens both follow the long ticks. In a traced run
it reads the requests due before the profiled slice (``harness.run``)."""
import math


def read(ctx):
    v = ctx.window.get("ttft_p90_s")
    return v if v is not None and math.isfinite(v) else None
