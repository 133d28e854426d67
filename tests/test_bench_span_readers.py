"""The benchmark's readers of the program's spans and counters
(``gnss_bench/metrics/``) on hand-built readings: the value each reads, and
None where the run holds nothing to read, as on a program without the
spans and counters."""

import json
import sys
from pathlib import Path

import pytest

from gnss_bench import registry, trace
from gnss_bench.run import Readings
from softgnss_tpu_torch.track import megakernel as mk
from softgnss_tpu_torch.track import scan

ROOT = Path(__file__).resolve().parent.parent
SPANS = {"track_wait_s": "track.wait", "track_to_host_s": "track.to_host",
         "demote_s": "track.demote", "acquire_tables_s": "acquire.tables",
         "acquire_wait_s": "acquire.wait"}
NEW = (*SPANS, "track_host_block_us", "track_ops_per_block")

JOBS = [{"acquire": 0.07, "acquire.tables": 0.01, "acquire.wait": 0.02, "track": 0.33,
         "track.loop": 0.26, "track.wait": 0.002, "track.to_host": 0.012, "track.demote": 0.03},
        {"acquire": 0.06, "acquire.tables": 0.03, "acquire.wait": 0.01, "track": 0.31,
         "track.loop": 0.24, "track.wait": 0.004, "track.to_host": 0.010, "track.demote": 0.02}]


def _trace(parts=True):
    """Two jobs; in each, ops in acquisition, in the loop, after it inside
    the stage (the sync's read-back), in the outputs' copy and in demotion."""
    tr = trace.Trace()
    tr.ranges[trace.JOB_RANGE] = [(0.0, 100.0), (100.0, 200.0)]
    tr.ranges["softgnss/acquire"] = [(0.0, 20.0), (100.0, 120.0)]
    tr.ranges["softgnss/track"] = [(20.0, 100.0), (120.0, 200.0)]
    if parts:
        tr.ranges["softgnss/track.loop"] = [(22.0, 60.0), (122.0, 160.0)]
        tr.ranges["softgnss/track.to_host"] = [(70.0, 80.0), (170.0, 180.0)]
        tr.ranges["softgnss/track.demote"] = [(80.0, 95.0), (180.0, 195.0)]
    for o in (0.0, 100.0):
        tr.device += [(o + 5, o + 15, "fft", True),
                      (o + 24, o + 30, "build_frames_bulk_kernel", True),
                      (o + 30, o + 50, "track_block_kernel", True),
                      (o + 50, o + 52, "build_frames_bulk_kernel", True),
                      (o + 52, o + 64, "track_block_kernel", True),
                      (o + 64, o + 65, "elementwise_kernel", True),
                      (o + 66, o + 67, "Memcpy DtoH", False),
                      (o + 71, o + 79, "Memcpy DtoH", False),
                      (o + 85, o + 86, "Memset", False)]
    return tr


def _readings(timings=JOBS, tr=None):
    return Readings(timings=list(timings), channels=2, n_ms=128, samples_per_code=4096,
                    trace=tr, traced_jobs=2)


@pytest.fixture
def counters(monkeypatch):
    """Three tracking calls of two blocks each in this process, the second
    block of each a graph replay."""
    monkeypatch.setattr(scan.track_segments, "calls", 3)
    monkeypatch.setattr(scan.track_segments, "segments", 6)
    monkeypatch.setattr(scan.track_segments, "graph_blocks", 3)


def read(name, r):
    return registry.metric(name).read(r)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_is_the_entry_beside_it(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == name)
    mod = registry.metric(name)
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"], entry["moves"])
    assert entry["moves"] == "capture_rate" and "workloads" not in entry
    want = "device_trace" if name == "track_ops_per_block" else "program_span"
    assert entry["source"] == want and entry["better"] == "lower"


@pytest.mark.parametrize("name", sorted(SPANS))
def test_a_span_reader_takes_the_mean_over_the_jobs(name):
    key = SPANS[name]
    assert read(name, _readings()) == pytest.approx((JOBS[0][key] + JOBS[1][key]) / 2)
    assert read(name, _readings(timings=[])) is None


def test_graph_share_entry_is_the_reader_beside_it():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(m for m in bench["per_layer"] if m["name"] == "track_graph_share")
    mod = registry.metric("track_graph_share")
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"], entry["moves"])
    assert entry["moves"] == "capture_rate" and "workloads" not in entry
    assert entry["source"] == "program_span" and entry["better"] == "higher"
    assert bench["per_layer"][12] is entry           # appended after the first twelve


@pytest.mark.parametrize("graph_blocks,want", [(3, 50.0), (0, 0.0)])
def test_graph_share_reads_the_counters(counters, monkeypatch, graph_blocks, want):
    """The replayed blocks over every segment, 0 where nothing was replayed
    (the CPU), with or without a trace."""
    monkeypatch.setattr(scan.track_segments, "graph_blocks", graph_blocks)
    assert read("track_graph_share", _readings()) == pytest.approx(want)
    assert read("track_graph_share", _readings(tr=_trace())) == pytest.approx(want)


@pytest.mark.parametrize("calls,segments", [(0, 0), (2, 0)])
def test_graph_share_reads_nothing_without_a_call(counters, monkeypatch, calls, segments):
    monkeypatch.setattr(scan.track_segments, "calls", calls)
    monkeypatch.setattr(scan.track_segments, "segments", segments)
    assert read("track_graph_share", _readings()) is None


def test_graph_share_reads_nothing_on_a_program_without_the_counter(counters, monkeypatch):
    """The parent's tree counts calls and segments but not graph blocks; an
    older one has no counters, and a run may have no program at all."""
    monkeypatch.delattr(scan.track_segments, "graph_blocks")
    assert read("track_graph_share", _readings()) is None
    for attr in ("calls", "segments"):
        monkeypatch.delattr(scan.track_segments, attr)
    assert read("track_graph_share", _readings()) is None
    monkeypatch.setitem(sys.modules, "softgnss_tpu_torch.track.scan", None)
    assert read("track_graph_share", _readings()) is None


def test_host_time_per_block(counters):
    assert read("track_host_block_us", _readings()) == pytest.approx(1e6 * 0.25 / 2)


def test_ops_per_block_counts_what_the_loop_launched(counters):
    # per job: 4 kernels in the loop, then a kernel and the sync's read-back
    # in the stage; the fft lies in acquisition, a copy in to_host, the fill
    # in demotion
    assert read("track_ops_per_block", _readings(tr=_trace())) == pytest.approx(2 * 6 / (2 * 2))


def test_the_readers_find_nothing_on_a_program_without_spans(monkeypatch):
    """The parent's tree: stage keys alone, no part ranges, no counters."""
    for attr in ("calls", "segments"):
        monkeypatch.delattr(scan.track_segments, attr)
    stages = [{k: t[k] for k in ("acquire", "track")} for t in JOBS]
    r = _readings(timings=stages, tr=_trace(parts=False))
    assert {name: read(name, r) for name in NEW} == dict.fromkeys(NEW)
    r = _readings(tr=_trace())                       # spans, but no counters
    assert read("track_host_block_us", r) is None
    assert read("track_ops_per_block", r) is None


@pytest.mark.parametrize("calls,segments", [(0, 0), (2, 0)])
def test_no_call_counted_reads_nothing(monkeypatch, calls, segments):
    monkeypatch.setattr(scan.track_segments, "calls", calls)
    monkeypatch.setattr(scan.track_segments, "segments", segments)
    r = _readings(tr=_trace())
    assert read("track_host_block_us", r) is None
    assert read("track_ops_per_block", r) is None


def test_a_run_without_a_trace_or_the_program(counters, monkeypatch):
    assert read("track_ops_per_block", _readings()) is None
    empty = _trace()
    empty.device = []
    assert read("track_ops_per_block", _readings(tr=empty)) is None
    monkeypatch.setitem(sys.modules, "softgnss_tpu_torch.track.scan", None)
    assert read("track_host_block_us", _readings()) is None
    assert read("track_ops_per_block", _readings(tr=_trace())) is None


def test_short_path_share_entry_is_the_reader_beside_it():
    """The last entry, read in the two cells whose B1 launches it counts."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = bench["per_layer"][-1]
    mod = registry.metric("track_short_path_share")
    assert entry["name"] == "track_short_path_share"
    assert (mod.LAYER, mod.UNIT, mod.MOVES) == (entry["layer"], entry["unit"], entry["moves"])
    assert entry["source"] == "program_counter" and entry["better"] == "higher"
    assert entry["layer"] == next(m["layer"] for m in bench["per_layer"]
                                  if m["name"] == "track_roofline")
    assert entry["workloads"] == [c["name"] for c in bench["workloads"]]


@pytest.mark.parametrize("b1, b3, want", [((4, 4, 0), (0, 0, 0), 100.0),
                                          ((3, 2, 1), (1, 0, 1), 50.0),
                                          ((2, 0, 2), (0, 0, 0), 0.0)])
def test_short_path_share_reads_the_counters(monkeypatch, b1, b3, want):
    """B1's and B3's short-path launches over all their launches."""
    for wrapper, (n, short, general) in ((mk.track_block, b1), (mk.track_block_fused, b3)):
        monkeypatch.setattr(wrapper, "launches", n)
        monkeypatch.setattr(wrapper, "short_launches", short)
        monkeypatch.setattr(wrapper, "general_launches", general)
    assert read("track_short_path_share", _readings()) == pytest.approx(want)


def test_short_path_share_reads_nothing_without_a_launch_or_the_counters(monkeypatch):
    """No B1/B3 launch (the CPU, or the per-ms route); the parent's tree,
    whose wrappers count launches but no paths; no program at all."""
    for wrapper in (mk.track_block, mk.track_block_fused):
        monkeypatch.setattr(wrapper, "launches", 0)
    assert read("track_short_path_share", _readings()) is None
    monkeypatch.setattr(mk.track_block, "launches", 3)
    monkeypatch.delattr(mk.track_block, "short_launches")
    assert read("track_short_path_share", _readings()) is None
    monkeypatch.setitem(sys.modules, "softgnss_tpu_torch.track.megakernel", None)
    assert read("track_short_path_share", _readings()) is None
