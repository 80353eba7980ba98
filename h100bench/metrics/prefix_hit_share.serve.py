"""Share (%) of the prompt tokens served from the prefix cache: the delta
of the port's tpu_inf_tokens_prefix_cached_total over the window before
the profiled slice, over the prompt tokens of the requests whose first
token arrived then. It moves the open loop's TPOT: the port runs a
prefill as a step of its own, which every decoding stream waits out, so
a cached prefix shortens those waits."""

from h100bench.readers import delta


def read(ctx):
    w0, w1 = ctx["clean"]
    sent = sum(r["prompt_tokens"] for r in ctx["log"]
               if r["tokens"] and w0 <= r["tokens"][0] < w1)
    cached = delta(ctx, "tpu_inf_tokens_prefix_cached_total")
    if not sent or cached is None:
        return None
    return 100.0 * cached / sent
