"""The port's model journal against the JAX package's on the same
directories: segment files, offsets and reads are equal byte for byte,
over plain, rolled and compacted topics, in both directions."""

import os

import pytest

from flink_ms_tpu.serve import compact as ref_compact
from flink_ms_tpu.serve import consumer as ref_consumer
from flink_ms_tpu.serve import journal as RJ
from flink_ms_tpu_torch.serve import journal as PJ

ROWS = [f"{i},{'UI'[i % 2]},{i}.5;{-i}.25;0.125" for i in range(40)]


def _files(d):
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name), "rb") as f:
            out[name] = f.read()
    return out


def _rolled_reference(d, rolls=2, seg=200):
    """A topic the reference wrote with small segments until it rolled at
    least ``rolls`` times."""
    ref = RJ.Journal(d, "t", segment_bytes=seg)
    n = 0
    while len([s for s in os.listdir(d) if s.startswith("t.log")]) < rolls + 1:
        ref.append([ROWS[n % len(ROWS)]])
        n += 1
    return ref


def _all_reads(journal, start, end):
    """read_from and read_bytes_from at every offset in [start, end]: the
    reply, or the truncation error's (resume_offset, lossless)."""
    out = []
    for off in range(start, end + 1):
        try:
            lines = journal.read_from(off, max_bytes=64)
            raw = journal.read_bytes_from(off, max_bytes=64)
            out.append((lines, raw))
        except (RJ.OffsetTruncatedError, PJ.OffsetTruncatedError) as e:
            out.append(("truncated", e.resume_offset, e.lossless))
    return out


@pytest.mark.parametrize("compacted", [False, True])
def test_port_appends_to_a_rolled_reference_topic(tmp_path, compacted):
    """The repair: the port appends to the reference's ACTIVE segment and
    returns the logical end offset, after rolls and after a fold."""
    d = str(tmp_path / "j")
    ref = _rolled_reference(d)
    if compacted:
        assert ref_compact.compact_journal(
            ref, parse_fn=ref_consumer.parse_als_record,
            min_segments=1) is not None
        assert any(n.startswith("t.clog.") for n in os.listdir(d))
    last = ref.end_offset()
    port = PJ.Journal(d, "t", segment_bytes=200)
    mine = ["7,U,1.0;2.0", "8,I,3.0;4.0"]
    end = port.append(mine)
    fresh = RJ.Journal(d, "t")
    assert end == fresh.end_offset()
    assert fresh.read_from(last) == (mine, end)
    assert PJ.Journal(d, "t").read_from(last) == (mine, end)


@pytest.mark.parametrize("seg,retain", [(None, None), (150, None), (150, 2)])
def test_same_appends_give_identical_segment_files(tmp_path, seg, retain):
    dr, dp = str(tmp_path / "r"), str(tmp_path / "p")
    ref = RJ.Journal(dr, "t", segment_bytes=seg, retain_segments=retain)
    port = PJ.Journal(dp, "t", segment_bytes=seg, retain_segments=retain)
    for i in range(0, len(ROWS), 3):
        flush = i % 2 == 0
        assert port.append(ROWS[i:i + 3], flush=flush) == ref.append(
            ROWS[i:i + 3], flush=flush)
    port.sync()
    assert _files(dp) == _files(dr)
    assert port.end_offset() == ref.end_offset()
    assert port.start_offset() == ref.start_offset()
    assert port.tail_line() == ref.tail_line() == ROWS[-1]


@pytest.mark.parametrize("compacted", [False, True])
def test_reads_equal_at_every_offset(tmp_path, compacted):
    d = str(tmp_path / "j")
    ref = _rolled_reference(d, rolls=3, seg=120)
    for row in ROWS[:5]:
        ref.append([row])
    if compacted:
        ref_compact.compact_journal(
            ref, parse_fn=ref_consumer.parse_als_record, min_segments=1)
    port = PJ.Journal(d, "t")
    end = ref.end_offset()
    assert port.end_offset() == end
    assert port.start_offset() == RJ.Journal(d, "t").start_offset()
    got = _all_reads(port, 0, end + 2)
    want = _all_reads(RJ.Journal(d, "t"), 0, end + 2)
    assert got == want
    if compacted:
        assert any(r[0] == "truncated" and r[2] for r in got)
    # the whole topic back, as the reference's autopilot reads it
    from flink_ms_tpu.serve.autopilot import _read_journal_lines

    assert port.read_lines() == _read_journal_lines(d, "t")


def test_aligned_end_offset_with_a_torn_tail(tmp_path):
    dr, dp = str(tmp_path / "r"), str(tmp_path / "p")
    offs = []
    for d, J in ((dr, RJ), (dp, PJ)):
        j = J.Journal(d, "t", segment_bytes=100)
        for row in ROWS[:8]:
            j.append([row])
        # a producer mid-append: bytes without their newline
        _, path = j._active_segment_scan()
        with open(path, "a") as f:
            f.write("99,U,1.0;")
        offs.append((j.end_offset(), j.aligned_end_offset(), j.tail_line(),
                     j.read_from(j.aligned_end_offset() - 10)))
    assert offs[0] == offs[1]
    end, aligned, tail, _ = offs[1]
    assert end - aligned == len("99,U,1.0;")
    assert tail == ROWS[7]


def test_truncated_after_retention_has_the_same_resume_offset(tmp_path):
    dr, dp = str(tmp_path / "r"), str(tmp_path / "p")
    errs = []
    for d, J in ((dr, RJ), (dp, PJ)):
        j = J.Journal(d, "t", segment_bytes=100, retain_segments=2)
        for row in ROWS[:30]:
            j.append([row])
        assert j.start_offset() > 0
        with pytest.raises(J.OffsetTruncatedError) as e:
            j.read_from(0)
        errs.append((e.value.resume_offset, e.value.lossless,
                     j.read_from(0, on_truncated="reset"),
                     j.expired_bytes_skipped))
    assert errs[0] == errs[1]
    assert errs[1][1] is False


def test_reference_reads_what_the_port_rolls(tmp_path):
    """The other direction: the port rolls, the reference reads every row
    at the port's offsets."""
    d = str(tmp_path / "j")
    port = PJ.Journal(d, "t", segment_bytes=40)
    ends = [port.append([row]) for row in ROWS[:12]]
    assert len([n for n in os.listdir(d) if n.startswith("t.log")]) > 3
    ref = RJ.Journal(d, "t")
    assert ref.end_offset() == ends[-1]
    got, off = [], 0
    while True:
        lines, off2 = ref.read_from(off)
        if off2 == off:
            break
        got.extend(lines)
        off = off2
    assert got == ROWS[:12]
    assert ref.read_from(ends[5])[0][0] == ROWS[6]


def test_bad_arguments_are_refused():
    with pytest.raises(ValueError, match="invalid topic"):
        PJ.Journal("/nonexistent-never-made", ".x")
    with pytest.raises(ValueError, match="segment_bytes"):
        PJ.Journal("/nonexistent-never-made", "t", segment_bytes=0)
    with pytest.raises(ValueError, match="on_truncated"):
        PJ.Journal.read_bytes_from(object.__new__(PJ.Journal), 0,
                                   on_truncated="skip")
