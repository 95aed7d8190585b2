"""Entry: the public deflate_tpu_torch.compress(chunk, level, device): a
raw RFC 1951 stream, encoded in segments of 64 blocks and stitched on the
host."""
from __future__ import annotations

from codecbench import judge


class Driver:
    def __init__(self, config: dict, device):
        import deflate_tpu_torch

        self.entry = deflate_tpu_torch.compress
        self.level = config["level"]
        self.device = device

    def prepare(self, chunks):
        return list(chunks)

    def call(self, chunk):
        return self.entry(chunk, self.level, device=self.device), None

    def faulty(self, fault, chunk):
        if fault == "half":
            return self.call(chunk[:len(chunk) // 2])
        stream, note = self.call(chunk)
        if fault == "unchanged":
            return chunk, note
        return judge.flip(stream), note

    def out_bytes(self, out) -> int:
        return len(out)

    def io_bytes(self, chunk, out) -> int:
        """The chunk read, the stream written."""
        return len(chunk) + len(out)

    def judge(self, chunks, ops):
        return judge.judge_streams(chunks, ops)

    def detail(self, inputs, ops) -> dict:
        return {"stream_bytes": sum(o.size for o in ops)}

    def close(self):
        pass
