"""Mean decode slots per decode step in the window before the profiled
slice: the tokens that the port's fused decode calls surfaced
(tpu_inf_tokens_per_dispatch, observed only by decode calls,
engine/engine.py) over the calls times their steps
(decode_steps_per_call)."""

from h100bench.readers import delta


def read(ctx):
    calls = delta(ctx, "tpu_inf_tokens_per_dispatch_count")
    if not calls:
        return None
    tokens = delta(ctx, "tpu_inf_tokens_per_dispatch_sum")
    return tokens / (calls * ctx["engine"]["decode_steps_per_call"])
