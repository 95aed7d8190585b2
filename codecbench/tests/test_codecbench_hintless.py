"""The archive-l2-hintless configuration: manifests with a block table and
no entry phases, written in set-up and read by decode_all through K6 (its
plain version on the CPU), and the reader of K6's span, on the CPU at a
small size."""
import pytest

from codecbench import harness, program
from codecbench.reference.inflate import inflate
from helpers import TINY

CELL = "archive-l2-hintless.read"
SEED = 2 ** 31 + 2417
READER = "block_inflate_self_ms_per_MiB"


@pytest.fixture(scope="module")
def run():
    r = harness.Run(harness.load_cell(CELL), SEED, "cpu", **TINY)
    yield r
    r.close()


def _alone(stream: bytes, bit_offset: int):
    """The block at bit_offset as a stream of its own that the reference
    reads from bit 0, with BFINAL set: after a fixed block of j 9-bit
    literals (byte 200), so that the block keeps its bit phase in a byte,
    on which a stored block's padding depends.  Returns (stream, j)."""
    j = (bit_offset - 2) % 8
    bits, n = 0b010, 3                  # BFINAL 0, BTYPE 01, LSB first
    code = 0b110010000 + 200 - 144      # sent from its top bit down
    for _ in range(j):
        for k in range(9):
            bits |= ((code >> (8 - k)) & 1) << n
            n += 1
    n += 7                              # end-of-block, code 0000000
    assert n % 8 == bit_offset % 8
    block = int.from_bytes(stream, "little") >> bit_offset | 1
    nbits = n + 8 * len(stream) - bit_offset
    return (bits | block << n).to_bytes(-(-nbits // 8), "little"), j


def test_the_cell_sets_up_manifests_without_hints(run):
    assert run.cell.config["hints"] is False
    assert run.cell.spec["driver"] == "manifest_decode"
    for chunk, (stream, man) in zip(run.chunks, run.inputs):
        assert man.hints is None
        assert man.block_size == run.cell.config["block_size"]
        assert len(man.blocks) == 2 and man.out_size == len(chunk)


def test_each_block_decodes_alone_from_its_bit_offset(run):
    """The reference, started at each block's bit offset, decodes the
    block alone to its slice of the chunk, over its bit length."""
    for chunk, (stream, man) in zip(run.chunks, run.inputs):
        pos = 0
        for off, bit_len, out_len in man.blocks:
            alone, j = _alone(stream, off)
            out, blocks = inflate(alone, max_out=j + out_len)
            assert out[:j] == bytes([200]) * j
            assert out[j:] == chunk[pos:pos + out_len]
            assert (blocks[1].bit_len, blocks[1].out_len) == (bit_len,
                                                              out_len)
            pos += out_len
        assert pos == len(chunk)


def test_the_run_is_correct_and_no_block_is_decoded_on_the_host(run):
    ops = run.loop(0) + run.loop(0, first=1)
    checks = run.judge(ops)
    assert harness.verdict(checks, ops), checks
    assert all(o.note is None for o in ops)
    assert run.driver.host_blocks == 0


@pytest.mark.parametrize("fault", harness.FAULTS)
def test_each_fault_is_not_correct(run, fault):
    ops = run.loop(0, fault=fault) + run.loop(0, first=1)
    checks = run.judge(ops)
    assert not harness.verdict(checks, ops)
    assert checks["ops_wrong"][0] == 1, checks


def test_the_reader_of_k6_s_span_reads_a_recorded_window(run):
    m = program.recorder()
    m.stop()
    m.reset()
    try:
        with m.recording(sync=False):
            ops = run.loop(0) + run.loop(0, first=1)
        ctx = harness.Context(run, ops, 1.0)
        assert harness.reader(READER).read(ctx) > 0
        snap = program.window()
        assert snap["spans"]["decode.block_inflate"]["n"] == len(ops)
        assert snap["counts"] == {"decode.path.pallas_scalar": len(ops)}
    finally:
        m.stop()
        m.reset()


def test_the_reader_is_silent_without_k6_s_span(run, monkeypatch):
    """The parent commit's program: a recorder, no decode.block_inflate."""
    ctx = harness.Context(run, [harness.Op(0, 0.0, 1.0, b"", None)], 1.0)
    monkeypatch.setattr(program, "window", lambda: {
        "ops": 1, "counts": {},
        "spans": {"decode": {"n": 1, "total_s": 1.0, "self_s": 1.0}}})
    assert harness.reader(READER).read(ctx) is None
    monkeypatch.setattr(program, "window", lambda: None)
    assert harness.reader(READER).read(ctx) is None
