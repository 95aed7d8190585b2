"""Decode host preparation: ops/wave.parse_headers_host and
prepare_windows, and models/wave_decoder.skeleton_plan where the stream
has no manifest.  ms per MiB of output, from synchronised spans."""

SPANS = [("deflate_tpu_torch.ops.wave", "parse_headers_host"),
         ("deflate_tpu_torch.ops.wave", "prepare_windows"),
         ("deflate_tpu_torch.models.wave_decoder", "skeleton_plan")]


def read(ctx):
    return ctx.ms_per_mib(ctx.span_seconds(SPANS))
