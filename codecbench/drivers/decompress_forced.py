"""Entry: the public deflate_tpu_torch.decompress(raw, device,
force_device=True, stats), on raw streams that Python's zlib wrote in
set-up with the configuration's settings: the device decode of streams
written by others (native skeleton walk, wavefront decode with a 32 KiB
history, K5).

Without force_device the port sends such streams to the host decoder.
decompress tries the wavefront decoder, then K6, then the speculative
decoder, which itself falls back to the host; its stats name the one it
tried last.  An op that the wavefront decoder did not serve counts as
failed, with the path in its note: the call asked for the card, and the
cell exists to measure the skeleton walk, the wave glue and K5."""
from __future__ import annotations

import collections
import zlib

from codecbench import judge


class Driver:
    def __init__(self, config: dict, device):
        import deflate_tpu_torch

        self.entry = deflate_tpu_torch.decompress
        self.writer = config["zlib_writer"]
        self.device = device
        self.paths = collections.Counter()

    def prepare(self, chunks):
        w = self.writer
        out = []
        for c in chunks:
            co = zlib.compressobj(w["level"], zlib.DEFLATED,
                                  -w["window_bits"], w["mem_level"],
                                  getattr(zlib, w["strategy"]))
            out.append(co.compress(c) + co.flush())
        return out

    def call(self, raw):
        st = {}
        out = self.entry(raw, device=self.device, force_device=True,
                         stats=st)
        path = st.get("device_path")
        self.paths[path] += 1
        return out, (None if path == "wave" else f"served by {path}")

    def faulty(self, fault, raw):
        out, note = self.call(raw)
        if fault == "unchanged":
            return raw, note
        if fault == "half":
            return out[:len(out) // 2], note
        return judge.flip(out), note

    def out_bytes(self, out) -> int:
        return len(out)

    def io_bytes(self, raw, out) -> int:
        """The stream read, the decoded bytes written."""
        return len(raw) + len(out)

    def judge(self, chunks, ops):
        return judge.judge_decoded(chunks, ops)

    def detail(self, inputs, ops) -> dict:
        return {"stream_bytes": sum(len(inputs[o.index]) for o in ops),
                "device_path_in_process": dict(self.paths)}

    def close(self):
        pass
