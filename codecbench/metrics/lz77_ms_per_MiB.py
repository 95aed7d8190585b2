"""Encode planning, ops/lz77 (find_matches, greedy_parse): ms per MiB of
input, from synchronised spans around those calls."""

SPANS = [("deflate_tpu_torch.ops.lz77", "find_matches"),
         ("deflate_tpu_torch.ops.lz77", "greedy_parse")]


def read(ctx):
    return ctx.ms_per_mib(ctx.span_seconds(SPANS))
