"""MODEL_FLOPS (2 x active parameters x prompt and generated tokens) of the
untraced window over its seconds, as a share of the bf16 peak, in %."""

from h100bench.lib import readers


def read(run):
    return readers.mfu(run, "serve", run.traced_info.get("window_tokens"))
