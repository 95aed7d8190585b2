"""The wavefront decode's stage C-F torch glue: ops/wave.resolve_litval
and merge_match_runs.  ms per MiB of output, from synchronised spans."""

SPANS = [("deflate_tpu_torch.ops.wave", "resolve_litval"),
         ("deflate_tpu_torch.ops.wave", "merge_match_runs")]


def read(ctx):
    return ctx.ms_per_mib(ctx.span_seconds(SPANS))
