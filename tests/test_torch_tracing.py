"""The port's spans and counters (nerf_mae_torch/tracing.py), on the CPU.

Off (no profiler): a tiny MAE train_step records nothing, enters no
record_function of the port's, creates no CUDA event and inserts no
autograd node. On (torch.profiler, CPU): the step's numbers are bitwise
those of the step without it; the spans nest under nerf_mae.train_step
with its step; each is a profiler range of its name inside its
time.time_ns() interval; the pieces' backward records partition the
backward; the feed's spans on the pool's threads carry their thread; the
counters add up; --profile_dir writes the operator's table.
"""

import json
import os
import socket
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from nerf_mae_torch import common, tracing
from nerf_mae_torch.config import MAEConfig, SwinConfig, TrainConfig
from nerf_mae_torch.data import SceneDataset, mae_batch_iterator
from nerf_mae_torch.data.device_cache import device_corpus_batches
from nerf_mae_torch.parallel.mesh import all_reduce_grads, make_mesh
from nerf_mae_torch.train.trainer import MAETrainer

torch.set_num_threads(1)

TINY = MAEConfig(swin=SwinConfig(embed_dim=12, depths=(1, 1, 2, 1), num_heads=(3, 6, 12, 24)),
                 resolution=32, compute_dtype="float32")
MODEL = ("embed", "stage0", "stage1", "stage2", "stage3", "decoder4", "decoder3",
         "decoder2", "head", "loss")
# the order the backward reaches the pieces' outputs
BACKWARD = ["loss", "head", "decoder2", "decoder3", "decoder4", "stage3", "merge3", "stage2",
            "merge2", "stage1", "merge1", "stage0", "embed"]


def _profiled():
    return profile(activities=[ProfilerActivity.CPU])


def _trainer_state(seed=0):
    trainer = MAETrainer(TINY, TrainConfig(batch_size=2), 100, device="cpu")
    return trainer, trainer.init(seed)


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    grids = rs.rand(2, 32, 32, 32, 4).astype(np.float32)
    grids[..., 3] *= rs.rand(2, 32, 32, 32) > 0.5
    return {"grids": torch.from_numpy(grids),
            "sizes": torch.tensor([[32, 29, 31], [27, 32, 32]], dtype=torch.int32)}


@pytest.fixture(autouse=True)
def fresh():
    tracing.reset()
    yield
    tracing.reset()


def _by_name(recs):
    out = {}
    for r in recs:
        out.setdefault(r.name, []).append(r)
    return out


def test_off_records_nothing(monkeypatch):
    """No profiler: no record, no range of the port's, no CUDA event, no
    mark node, even where a CUDA context exists."""
    names, events, marks = [], [], []
    init = torch.autograd.profiler.record_function.__init__

    def spy_init(self, name, *a, **k):
        names.append(name)
        init(self, name, *a, **k)

    class Event:
        def __init__(self, *a, **k):
            events.append(1)

    apply = tracing._Mark.apply
    monkeypatch.setattr(torch.autograd.profiler.record_function, "__init__", spy_init)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(tracing._Mark, "apply", lambda *a: marks.append(1) or apply(*a))
    trainer, state = _trainer_state()
    trainer.train_step(state, _batch())
    pred, _ = state.model(_batch()["grids"], False, generator=torch.Generator().manual_seed(0),
                          droppath_generator=torch.Generator().manual_seed(1))
    seen, todo = set(), [pred.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        todo.extend(f for f, _ in fn.next_functions)
    assert not tracing.on()
    assert tracing.records() == [] and all(
        k.endswith((".launches", ".kept", ".kept_bytes")) for k in tracing.counters())
    assert any(n.startswith("Optimizer.step") for n in names)  # the spy sees ranges
    assert not [n for n in names if n.startswith("nerf_mae.")]
    assert events == [] and marks == []
    assert not [fn for fn in seen if "Mark" in type(fn).__name__]
    assert tracing.span("nerf_mae.forward") is tracing.span("nerf_mae.backward")


def test_profiled_step_is_bitwise():
    """train_step under the profiler (spans, marks, counts on) gives the
    loss, gradients and parameters of the step without it, bit for bit."""
    runs = []
    for traced in (False, True):
        trainer, state = _trainer_state()
        if traced:
            with _profiled():
                state, m = trainer.train_step(state, _batch())
            assert tracing.records()
        else:
            state, m = trainer.train_step(state, _batch())
        runs.append((m, {k: (p.detach().clone(), p.grad.clone())
                         for k, p in state.model.named_parameters()}))
    (m0, p0), (m1, p1) = runs
    for k in m0:
        assert torch.equal(m0[k], m1[k]), k
    for k in p0:
        assert torch.equal(p0[k][0], p1[k][0]) and torch.equal(p0[k][1], p1[k][1]), k


def test_spans_nest_with_parents_and_steps():
    trainer, state = _trainer_state()
    with _profiled():
        for _ in range(2):
            state, _ = trainer.train_step(state, _batch())
    recs = tracing.records()
    by_id = {r.id: r for r in recs}
    parent = lambda r: None if r.parent is None else by_id[r.parent].name
    named = _by_name(recs)
    assert [r.step for r in named["nerf_mae.train_step"]] == [0, 1]
    for r in named["nerf_mae.train_step"]:
        assert r.parent is None
    for n in ("forward", "backward", "optimizer"):
        assert [parent(r) for r in named[f"nerf_mae.{n}"]] == ["nerf_mae.train_step"] * 2
    for n in MODEL:
        assert [parent(r) for r in named[f"nerf_mae.{n}"]] == ["nerf_mae.forward"] * 2, n
    for s in (1, 2, 3):
        assert [parent(r) for r in named[f"nerf_mae.merge{s}"]] == [f"nerf_mae.stage{s}"] * 2
    for n in ("clip", "adamw"):
        assert [parent(r) for r in named[f"nerf_mae.{n}"]] == ["nerf_mae.optimizer"] * 2
    assert "nerf_mae.allreduce" not in named  # no mesh
    for r in recs:  # every record carries its step and the thread it ran on
        assert r.step in (0, 1) and r.thread == threading.get_native_id()
        if r.parent is not None:
            assert by_id[r.parent].step == r.step
            assert by_id[r.parent].start_ns <= r.start_ns <= r.end_ns <= by_id[r.parent].end_ns
    assert all(r.device_ms is None for r in recs)  # no card: host times only


def test_spans_are_profiler_ranges_inside_their_interval():
    """Each record is a profiler range of its name; placed on the host
    clock (trace_start_ns + 1000 * time_range), the range lies inside the
    record's time.time_ns() interval (to the profiler's 1 ns rounding)."""
    trainer, state = _trainer_state()
    with _profiled() as prof:
        trainer.train_step(state, _batch())
    recs = tracing.records()
    start_ns = prof.profiler.kineto_results.trace_start_ns()
    ranges = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith("nerf_mae."):
            ranges.setdefault(e.name, []).append(e)
    named = _by_name(recs)
    assert set(ranges) == set(named)
    assert len(named) == 4 + 10 + 3 + 2 + 13  # phases, pieces, merges, clip + adamw, .bwd
    for name, rs in named.items():
        assert len(ranges[name]) == len(rs), name
        for r, e in zip(rs, ranges[name]):
            a = start_ns + round(1000 * e.time_range.start)
            b = start_ns + round(1000 * e.time_range.end)
            assert r.start_ns - 1 <= a <= b <= r.end_ns + 1, (name, r.start_ns - a, b - r.end_ns)


def test_backward_marks_partition_the_backward():
    trainer, state = _trainer_state()
    with _profiled():
        trainer.train_step(state, _batch())
    recs = tracing.records()
    (bwd,) = [r for r in recs if r.name == "nerf_mae.backward"]
    pieces = [r for r in recs if r.name.endswith(tracing.BWD)]
    assert [r.name for r in pieces] == [f"nerf_mae.{n}.bwd" for n in BACKWARD]
    for a, b in zip(pieces, pieces[1:]):
        assert a.end_ns == b.start_ns  # one reading ends a piece and starts the next
    assert bwd.start_ns <= pieces[0].start_ns and pieces[-1].end_ns <= bwd.end_ns
    covered = pieces[-1].end_ns - pieces[0].start_ns
    assert covered >= 0.97 * (bwd.end_ns - bwd.start_ns)
    assert all(r.parent is None and r.step == 0 for r in pieces)


class FakeEvent:
    """A CUDA event's surface on the host clock: record() reads it."""
    made = 0

    def __init__(self, enable_timing=False):
        FakeEvent.made += 1
        self.t = None

    def record(self, stream=None):
        self.t = time.perf_counter()

    def synchronize(self):
        pass

    def elapsed_time(self, other):
        return (other.t - self.t) * 1e3


def test_device_intervals_from_events(monkeypatch):
    """With a CUDA context each record reads a device interval from its
    events; the backward's pieces share the event that ends one and starts
    the next; reset() returns the events to the pool."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    FakeEvent.made = 0
    trainer, state = _trainer_state()
    with _profiled():
        state, _ = trainer.train_step(state, _batch())
    recs = tracing.records()
    made = FakeEvent.made
    assert all(r.device_ms is not None and r.device_ms >= 0 for r in recs)
    pieces = [r for r in recs if r.name.endswith(tracing.BWD)]
    for a, b in zip(pieces, pieces[1:]):
        assert a.device_end_ms == b.device_start_ms
    assert made == 2 * (len(recs) - len(pieces)) + len(pieces) + 1
    (step,) = [r for r in recs if r.name == tracing.ROOT]
    assert step.device_start_ms == 0.0  # the first event is the clock's zero
    tracing.reset()
    with _profiled():
        trainer.train_step(state, _batch())
    assert FakeEvent.made == made and len(tracing.records()) == len(recs)  # from the pool


def _scene_dir(tmp_path, n=4):
    rs = np.random.RandomState(0)
    for i in range(n):
        np.savez(tmp_path / f"s{i}.npz", rgbsigma=rs.rand(20, 24, 16, 4).astype(np.float32))
    return str(tmp_path)


def test_feed_spans_on_pool_threads(tmp_path):
    ds = SceneDataset(_scene_dir(tmp_path), flip_prob=0.5, rotate_prob=0.5, seed=3)
    it = mae_batch_iterator(ds, 2, 32, seed=0, workers=2)
    main = threading.get_native_id()
    with _profiled():
        for _ in range(2):
            next(it)
    it.close()
    named = _by_name(tracing.records())
    assert len(named["nerf_mae.feed.read"]) == 4 and len(named["nerf_mae.feed.augment"]) == 4
    # a scene's pad on the pool, the batch's assembly on the caller
    collate = named["nerf_mae.feed.collate"]
    assert len(collate) == 6 and sum(r.thread == main for r in collate) == 2
    for n in ("read", "augment"):
        assert all(r.thread != main for r in named[f"nerf_mae.feed.{n}"]), n
    assert all(r.device_ms is None for recs in named.values() for r in recs)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_counters_add_up():
    corpus = {"grids": np.zeros((6, 8, 8, 8, 4), np.float32),
              "sizes": np.full((6, 3), 8, np.int32)}
    feed = device_corpus_batches(corpus, "cpu", 2, seed=0)
    next(feed)  # off: not counted
    with _profiled():
        for _ in range(3):
            next(feed)
        host = common.overlap_batches(iter([corpus] * 2), torch.device("cpu"), 0)
        list(host)
    c = tracing.counters()
    assert c["feed.batches"] == 3 + 2
    assert c["feed.h2d_bytes"] == 3 * 2 * 8  # the index vectors
    assert c["fused_swin_block.launches"] >= 0
    names = [r.name for r in tracing.records()]
    assert names.count("nerf_mae.feed.gather") == 3

    tracing.reset()
    params = [torch.nn.Parameter(torch.ones(5)), torch.nn.Parameter(torch.ones(2, 3))]
    for p in params:
        p.grad = torch.ones_like(p)
    with make_mesh(1, device="cpu", backend="gloo", rank=0, world_size=1,
                   init_method=f"tcp://localhost:{_free_port()}") as mesh:
        all_reduce_grads(params, mesh)  # off: not counted
        with _profiled():
            for _ in range(2):
                all_reduce_grads(params, mesh)
        c = tracing.counters(mesh)
        assert c["allreduce.calls"] == 2 and c["allreduce.bytes"] == 2 * 11 * 4
        assert c["mesh.grad_bytes"] == 3 * 11 * 4
        assert [r.name for r in tracing.records()] == ["nerf_mae.allreduce"] * 2
    tracing.reset()
    assert tracing.counters().get("feed.batches") is None


def test_profile_dir_writes_the_span_table(tmp_path):
    """The operator's reading: maybe_profile logs and writes the table of
    the wrapped steps' spans and counters beside the chrome trace."""
    trainer, state = _trainer_state()
    with common.maybe_profile(str(tmp_path), torch.device("cpu"), "train"):
        for _ in range(2):
            state, _ = trainer.train_step(state, _batch())
    (path,) = [p for p in os.listdir(tmp_path) if p.endswith(".spans.json")]
    assert os.path.isfile(tmp_path / path.replace(".spans.json", ".json"))
    with open(tmp_path / path) as f:
        t = json.load(f)
    assert t["steps"] == 2
    rows = {r["span"]: r for r in t["spans"]}
    assert rows["nerf_mae.train_step"]["calls_per_step"] == 1.0
    assert rows["nerf_mae.stage2.bwd"]["calls_per_step"] == 1.0
    step = rows["nerf_mae.train_step"]
    phases = sum(rows[f"nerf_mae.{n}"]["host_ms"] for n in ("forward", "backward", "optimizer"))
    assert step["self_host_ms"] == pytest.approx(step["host_ms"] - phases, abs=1e-6)
    assert all(r["device_interval_ms"] is None for r in t["spans"])  # no card
    assert set(t["counters"]) >= {"fused_swin_block.launches", "fused_swin_block_bwd.launches"}
    assert not tracing.on()
    # the text logged is the same table
    assert "nerf_mae.optimizer" in tracing.format_table(t)


def test_threads_lose_no_count_or_record():
    """Counts and records from more threads than cores, switching often:
    none is lost, every record keeps its own id, no thread's span is
    another's parent."""
    n_threads, n = 4 * (os.cpu_count() or 1), 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        for _ in range(n):
            with tracing.span("nerf_mae.feed.read", events=False):
                tracing.count("feed.batches")
                tracing.count("feed.h2d_bytes", 3)

    try:
        with _profiled():
            threads = [threading.Thread(target=work) for _ in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    c = tracing.counters()
    assert c["feed.batches"] == n_threads * n and c["feed.h2d_bytes"] == 3 * n_threads * n
    recs = tracing.records()
    assert len(recs) == n_threads * n and len({r.id for r in recs}) == len(recs)
    assert all(r.parent is None for r in recs)  # each thread keeps its own stack
