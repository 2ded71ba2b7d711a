"""The port's recorder (strainer2_tpu_torch/utils/observability.py): the
stage totals with recording off, spans and their nesting while it is on,
counters added from many threads, the self-time column of the timings
report, and the spans the port's stages leave on a small detection and
panel count."""

import gzip
import io
import os
import sys
import threading

import pytest

import strainer2_tpu_torch.utils.observability as obs
from strainer2_tpu_torch.utils.prefetch import prefetch

MINI = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden", "mini")


@pytest.fixture
def fresh(monkeypatch):
    """Empty totals and counters; recording stopped afterwards."""
    for name, kind in (("_totals", float), ("_items", int), ("_self", float)):
        monkeypatch.setattr(obs, name, type(obs._totals)(kind))
        monkeypatch.setattr(obs, "_thread" + name, type(obs._totals)(kind))
    yield obs
    obs.stop_recording()


def test_off_records_nothing_and_totals_add_up(fresh):
    for items in (2, 5):
        with obs.stage("a", items=items):
            with obs.stage("a.b"):
                pass
    obs.count("c", 3)
    assert obs._items["a"] == 7 and obs._items["c"] == 3
    assert obs._totals["a"] >= obs._totals["a.b"] > 0
    assert obs._lists == [] and not obs._recording
    obs.start_recording()
    spans, counters = obs.stop_recording()
    assert spans == [] and counters == {}
    assert obs._totals["a"] > 0 and obs._items["c"] == 3  # totals are kept


def test_spans_nest_on_their_threads(fresh):
    obs.start_recording()
    with obs.stage("outer"):
        with obs.stage("inner"):
            pass
        with obs.stage("inner"):
            pass

    def work():
        with obs.stage("worker"):
            with obs.stage("worker.step"):
                pass

    th = threading.Thread(target=work, name="obs-test-worker")
    th.start()
    th.join()
    with pytest.raises(KeyError):
        with obs.stage("failing"):
            raise KeyError("inside")
    spans, _ = obs.stop_recording()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    assert sorted(by) == ["failing", "inner", "outer", "worker", "worker.step"]
    assert all(s.start_ns <= s.end_ns for s in spans)
    assert [s.start_ns for s in spans] == sorted(s.start_ns for s in spans)
    assert len({s.id for s in spans}) == len(spans)
    (outer,) = by["outer"]
    assert outer.parent == 0 and outer.thread == threading.get_ident()
    assert outer.thread_name == threading.current_thread().name
    for s in by["inner"]:
        assert s.parent == outer.id and outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    (w,), (ws,) = by["worker"], by["worker.step"]
    assert w.thread == ws.thread != outer.thread and w.thread_name == "obs-test-worker"
    assert w.parent == 0 and ws.parent == w.id
    assert by["failing"][0].parent == 0


def test_count_from_eight_threads_sums_exactly(fresh):
    """Eight threads and the main thread add at once, with the interpreter
    switching threads as often as it can: no add is lost."""
    obs.start_recording()
    start = threading.Barrier(9, timeout=60)

    def work(i):
        start.wait()
        for _ in range(20_000):
            obs.count("many")
        for _ in range(200):
            with obs.stage("many.stage", items=1):
                pass
        obs.count("by_thread", i)

    threads = [threading.Thread(target=work, args=(i,)) for i in range(8)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for th in threads:
            th.start()
        start.wait()
        for _ in range(20_000):
            obs.count("many")
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    spans, counters = obs.stop_recording()
    assert counters["many"] == 9 * 20_000
    assert obs._thread_items["many"] == 8 * 20_000 and obs._items["many"] == 20_000
    assert counters["many.stage"] == 1600 and counters["by_thread"] == sum(range(8))
    assert len(spans) == 1600 and len({s.thread for s in spans}) == 8


def test_stop_recording_clears(fresh):
    obs.count("before", 4)
    obs.start_recording()
    with obs.stage("x", items=2):
        obs.count("y")
    spans, counters = obs.stop_recording()
    assert [s.name for s in spans] == ["x"] and counters == {"x": 2, "y": 1}
    assert obs._lists == [] and not obs._recording and not obs._nested
    with obs.stage("after"):
        pass
    assert obs.stop_recording() == ([], {})
    obs.start_recording()
    assert obs.stop_recording() == ([], {})
    assert obs._items["before"] == 4 and obs._items["x"] == 2


def test_span_open_across_start_is_not_kept(fresh):
    with obs.stage("open"):
        obs.start_recording()
        with obs.stage("child"):
            pass
    spans, _ = obs.stop_recording()
    assert [(s.name, s.parent) for s in spans] == [("child", 0)]


def test_report_has_self_time(fresh, monkeypatch, capsys):
    monkeypatch.setattr(obs, "_registered", True)
    monkeypatch.setattr(obs, "_nested", True)
    obs._totals.clear()
    with obs.stage("parent", items=10):
        with obs.stage("parent.child"):
            sum(range(200_000))
    obs.count("bare", 12345)
    assert obs._self["parent"] <= obs._totals["parent"] - obs._totals["parent.child"] + 1e-6
    assert obs._self["parent.child"] == pytest.approx(obs._totals["parent.child"])
    obs._report()
    err = capsys.readouterr().err
    assert "(total, self)" in err and "(10 items" in err
    line = next(l for l in err.splitlines() if " parent " in l)
    total, self_s = (float(x.rstrip("s")) for x in line.split()[2:4])
    assert self_s <= total
    assert "12,345" in err


def test_prefetch_names_its_thread_and_times_the_wait(fresh):
    seen = []

    def stream():
        for i in range(3):
            seen.append(threading.current_thread().name)
            yield i

    obs.start_recording()
    assert list(prefetch(stream())) == [0, 1, 2]
    spans, _ = obs.stop_recording()
    assert seen == ["s2-prefetch"] * 3
    waits = [s for s in spans if s.name == "prefetch.wait"]
    assert len(waits) == 4 and all(s.thread == threading.get_ident() for s in waits)


def _names(spans):
    return {s.name for s in spans}


def _detect_recorded(tmp_path, monkeypatch, mesh=None):
    """A small strain_detect -B on the CPU engine's route (one PE and one SE
    sample), recorded: its spans by name, its counters, the hits file's rows
    and the spans by id."""
    from strainer2_tpu_torch.pipeline.detect import DetectConfig, run_detect

    monkeypatch.chdir(MINI)
    monkeypatch.setenv("STRAINER2_NATIVE_COUNT", "0")
    batch = tmp_path / "targets.txt"
    batch.write_text("PE\tdata/target_PE1.fasta.gz\tdata/target_PE2.fasta.gz\n"
                     "SE\tdata/target_SE.fastq\n")
    out = tmp_path / "hits.gz"
    obs.start_recording()
    run_detect("data/strainA.fna.gz", "expected/scrubbed_m05.txt", str(out),
               batch_list=str(batch), cfg=DetectConfig(device="cpu", mesh=mesh),
               stdout=io.StringIO())
    spans, counters = obs.stop_recording()
    rows = [ln for ln in gzip.open(out, "rt") if not ln.startswith("#")]
    assert rows
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    return by, counters, rows, {s.id: s for s in spans}


def test_detect_spans_and_counters(fresh, tmp_path, monkeypatch):
    """The device route (K4 then K4e choose the rows; on the CPU their
    plain version): emission's span and its write, the engine's spans with
    the selection's inside the classify span, the gate, counters that agree
    with the hits file, every gated batch's rows from the selection, and no
    rescan or key search."""
    by, counters, rows, ids = _detect_recorded(tmp_path, monkeypatch)
    assert {"detect.score_samples", "detect.emit", "detect.emit.write", "engine.classify",
            "engine.select", "engine.h2d", "engine.gate_readback", "engine.d2h",
            "prefetch.wait", "pack.batch"} <= set(by)
    assert not {"detect.emit.rescan", "detect.emit.lookup"} & set(by)
    assert counters["engine.batches"] == len(by["engine.classify"]) == len(by["engine.h2d"])
    assert counters["engine.batches"] == len(by["engine.gate_readback"]) == len(by["engine.select"])
    assert counters["detect.gate_passed"] == len(by["engine.d2h"]) == len(by["detect.emit"])
    assert counters["detect.select_batches"] == counters["detect.gate_passed"]
    assert counters["pack.windows"] > 0 and counters["engine.h2d_bytes"] > 0
    assert counters["detect.rows"] == len(rows)
    assert 0 < counters["detect.reads_passing"] <= counters["detect.emit_reads"]
    main = threading.get_ident()
    (root,) = by["detect.score_samples"]
    # the index build packs on the main thread; the scan on the prefetch worker
    assert {s.thread_name for s in by["pack.batch"]
            if root.start_ns <= s.start_ns <= root.end_ns} == {"s2-prefetch"}
    for name in ("detect.emit", "engine.classify", "engine.gate_readback", "engine.d2h",
                 "prefetch.wait"):
        assert all(s.thread == main and s.parent == root.id for s in by[name]), name
    assert all(ids[s.parent].name == "detect.emit" for s in by["detect.emit.write"])
    for name in ("engine.h2d", "engine.select"):
        assert all(ids[s.parent].name == "engine.classify" for s in by[name]), name


def test_detect_spans_and_counters_mesh_route(fresh, tmp_path, monkeypatch):
    """The mesh route (--mesh 1x1) keeps the host's emission: the rescan
    and key search of each passing read under emission's span, and no
    selection."""
    by, counters, rows, ids = _detect_recorded(tmp_path, monkeypatch, mesh=(1, 1))
    assert {"detect.emit", "detect.emit.rescan", "detect.emit.lookup",
            "detect.emit.write"} <= set(by)
    assert "engine.select" not in by and "detect.select_batches" not in counters
    assert counters["detect.rows"] == len(rows)
    assert 0 < counters["detect.reads_passing"] <= counters["detect.emit_reads"]
    for name in ("detect.emit.rescan", "detect.emit.lookup", "detect.emit.write"):
        assert all(ids[s.parent].name == "detect.emit" for s in by[name]), name


def test_scrub_feeder_spans_and_counters(fresh, monkeypatch):
    """kmer_scrub_count on the CPU engine with three feeder threads: each
    feeder's loop holds its packing, lock waits and dispatches; the counters
    agree with the spans and the table."""
    from strainer2_tpu_torch.pipeline.scrub_count import ScrubCountConfig, run_scrub_count

    monkeypatch.chdir(MINI)
    monkeypatch.setenv("STRAINER2_NATIVE_COUNT", "0")
    monkeypatch.setenv("STRAINER2_COUNT_THREADS", "3")
    out = io.StringIO()
    obs.start_recording()
    run_scrub_count("data/strainA.fna.gz", "data/genomes.txt", "data/pangenomes.txt", out=out,
                    cfg=ScrubCountConfig(device="cpu"))
    spans, counters = obs.stop_recording()
    by = {}
    for s in spans:
        by.setdefault(s.name, []).append(s)
    ids = {s.id: s for s in spans}
    feeds = by["scrub.feed"]
    # -A has 2 files, -B 3: a feeder a file
    assert len(feeds) == 5 and all(s.thread_name.startswith("s2-device-feed-") for s in feeds)
    feed_ids = {s.id for s in feeds}
    for name in ("pack.batch", "scrub.feed.lock_wait", "scrub.feed.dispatch"):
        # the index build packs too, under scrub.index_build on the main thread
        on_feeders = [s for s in by[name] if s.thread_name.startswith("s2-device-feed-")]
        assert on_feeders and all(s.parent in feed_ids for s in on_feeders), name
        assert all(ids[s.parent].name == "scrub.index_build" for s in by[name]
                   if s not in on_feeders), name
    assert all(ids[s.parent].name == "scrub.feed.dispatch" for s in by["engine.count"])
    assert counters["scrub.batches"] == len(by["scrub.feed.dispatch"]) == len(by["engine.count"])
    assert counters["engine.batches"] == counters["scrub.batches"]
    assert counters["pack.windows"] > counters["scrub.panel_lookups"]  # the index build's too
    (table,) = by["scrub.write_table"]
    assert table.thread == threading.get_ident()
    assert counters["scrub.rows"] == out.getvalue().count("\n") - 1
