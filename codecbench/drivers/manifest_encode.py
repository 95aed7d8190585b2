"""Entry: runtime/manifest.compress_with_manifest(chunk, level, hints,
device): one encode gives the stream, the block table and, where the
configuration asks for them, the entry-phase hints."""
from __future__ import annotations

from codecbench import judge


class Driver:
    def __init__(self, config: dict, device):
        from deflate_tpu_torch.runtime import manifest

        self.entry = manifest.compress_with_manifest
        self.level = config["level"]
        self.hints = config["hints"]
        self.spec = {"block_size": config["block_size"],
                     "hints": config["hints"]}
        self.device = device

    def prepare(self, chunks):
        return list(chunks)

    def call(self, chunk):
        return self.entry(chunk, level=self.level, hints=self.hints,
                          device=self.device), None

    def faulty(self, fault, chunk):
        if fault == "half":
            return self.call(chunk[:len(chunk) // 2])
        (stream, man), note = self.call(chunk)
        if fault == "unchanged":
            return (chunk, None), note
        return (judge.flip(stream), man), note

    def out_bytes(self, out) -> int:
        return len(out[0])

    def io_bytes(self, chunk, out) -> int:
        """Bytes the path must move: the chunk read, stream and manifest
        written."""
        return len(chunk) + len(out[0]) + len(out[1].to_bytes())

    def judge(self, chunks, ops):
        return judge.judge_streams(chunks, ops, self.spec)

    def detail(self, inputs, ops) -> dict:
        return {"stream_bytes": sum(o.size for o in ops)}

    def close(self):
        pass
