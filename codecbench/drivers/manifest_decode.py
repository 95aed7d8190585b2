"""Entry: runtime/manifest.decode_all(stream, manifest, device), on
streams and manifests the port wrote in set-up with
compress_with_manifest at the configuration's level and hints: with
hints the wavefront decode, without them K6.

decode_all decodes a block that the device path flags, or with no hints
a stream that K6 flags, on the host, one block at a time, through
models/host_inflate.inflate_raw.  A counting pass-through around that
function, installed from here, counts those blocks; an op with any
counts as failed: the call asked for the card."""
from __future__ import annotations

from codecbench import judge
from codecbench.trace import Patches


class Driver:
    def __init__(self, config: dict, device):
        from deflate_tpu_torch.runtime import manifest

        self.manifest = manifest
        self.level = config["level"]
        self.hints = config["hints"]
        self.device = device
        self.host_blocks = 0
        self.patches = Patches()

        def count(orig):
            def wrapper(*a, **k):
                self.host_blocks += 1
                return orig(*a, **k)
            return wrapper
        self.patches.wrap("deflate_tpu_torch.models.host_inflate",
                          "inflate_raw", count)

    def prepare(self, chunks):
        return [self.manifest.compress_with_manifest(
            c, level=self.level, hints=self.hints, device=self.device)
            for c in chunks]

    def call(self, inp):
        before = self.host_blocks
        out = self.manifest.decode_all(*inp, device=self.device)
        n = self.host_blocks - before
        return out, (f"{n} blocks decoded on the host" if n else None)

    def faulty(self, fault, inp):
        out, note = self.call(inp)
        if fault == "unchanged":
            return inp[0], note
        if fault == "half":
            return out[:len(out) // 2], note
        return judge.flip(out), note

    def out_bytes(self, out) -> int:
        return len(out)

    def io_bytes(self, inp, out) -> int:
        """The stream read, the decoded bytes written."""
        return len(inp[0]) + len(out)

    def judge(self, chunks, ops):
        return judge.judge_decoded(chunks, ops)

    def detail(self, inputs, ops) -> dict:
        return {"stream_bytes": sum(len(inputs[o.index][0]) for o in ops),
                "host_blocks_in_process": self.host_blocks}

    def close(self):
        self.patches.undo()
