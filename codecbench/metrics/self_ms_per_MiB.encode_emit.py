"""Self time of the program's encode.trees, encode.choose, encode.emit and
encode.hints spans (histograms, Huffman trees and K1, the block choice,
emission, the hints) in the traced window, ms per MiB of input
(codecbench/program.py)."""
from codecbench import program


def read(ctx):
    return program.self_ms_per_mib(ctx, "encode_emit")
