"""Everything of an encode but ops/lz77: emission, trees (K1), stitching
and the manifest.  The ops' own time less the lz77 spans, ms per MiB of
input."""

SPANS = [("deflate_tpu_torch.ops.lz77", "find_matches"),
         ("deflate_tpu_torch.ops.lz77", "greedy_parse")]


def read(ctx):
    lz77 = ctx.span_seconds(SPANS)
    if lz77 is None:
        return None
    return ctx.ms_per_mib(ctx.op_seconds - lz77)
