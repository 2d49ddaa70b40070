"""The port's spans (utils/profiling.py ``span``, ``spans``, ``SpanRing``):
what a record holds, self time under a child, the ring's bound, the
``sivae.*`` events a torch profile gets, the feed's spans in
``device_prefetch`` and ``HostRings`` on the CPU, and a kernel build's span.
On the card (``cuda`` marker; skipped without one): a graphed step's
warm-up, capture and replay spans, and each replay's event holding its
``cudaGraphLaunch`` and opening before that launch's first device operation,
on the profile's one clock."""

import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from soft_intro_vae_torch.data.prefetch import HostRings, Transfer, device_prefetch, device_put_fn
from soft_intro_vae_torch.ops import cuda_build
from soft_intro_vae_torch.train.graph import WARMUP_STEPS, one_step
from soft_intro_vae_torch.utils import profiling
from soft_intro_vae_torch.utils.profiling import SpanRing, SpansLost, span
from tests.torch_port_fixtures import cuda_device, one_torch_thread  # noqa: F401


@pytest.fixture
def ring(monkeypatch):
    """A ring of the test's own in place of the program's."""
    r = SpanRing()
    monkeypatch.setattr(profiling, "RING", r)
    return r


def _mine(t0, names=None):
    """This thread's records in the shared ring since ``t0``."""
    me = threading.get_ident()
    return [r for r in profiling.spans(t0) if r.thread == me
            and (names is None or r.name in names)]


def test_a_span_records_name_thread_times_parent_and_batch(ring):
    before = time.perf_counter_ns()
    with span("outer", 7):
        with span("inner"):
            pass
    after = time.perf_counter_ns()
    inner, outer = ring.spans()
    assert (inner.name, outer.name) == ("inner", "outer")
    assert inner.thread == outer.thread == threading.get_ident()
    assert before <= outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns <= after
    assert outer.parent is None and inner.parent == outer.id
    assert (outer.batch, inner.batch) == (7, None)


def test_self_time_leaves_out_child_spans(ring):
    with span("put"):
        time.sleep(0.002)
        with span("slot_wait"):
            time.sleep(0.03)
        with span("slot_wait"):
            time.sleep(0.01)
    a, b, put = ring.spans()
    assert put.child_ns == a.dur_ns + b.dur_ns
    assert put.self_ns == put.dur_ns - a.dur_ns - b.dur_ns
    assert 0.002e9 <= put.self_ns < 0.03e9 and a.self_ns == a.dur_ns


def test_spans_on_two_threads_have_parents_of_their_own(ring):
    entered, done = threading.Event(), threading.Event()

    def worker():
        with span("worker"):
            entered.set()
            done.wait(10)

    t = threading.Thread(target=worker)
    with span("loop"):
        t.start()
        assert entered.wait(10)
        with span("loop.child"):
            pass
        done.set()
        t.join(10)
    assert not t.is_alive()
    by = {r.name: r for r in ring.spans()}
    assert by["worker"].parent is None and by["worker"].thread != by["loop"].thread
    assert by["loop.child"].parent == by["loop"].id


def test_the_ring_is_bounded_and_says_when_it_no_longer_reaches_back(monkeypatch):
    ring = SpanRing(size=4)
    monkeypatch.setattr(profiling, "RING", ring)
    marks = []
    for i in range(6):
        marks.append(time.perf_counter_ns())
        with span("s", i):
            pass
    assert len(ring.records) == 4
    assert [r.batch for r in ring.spans()] == [2, 3, 4, 5]
    assert [r.batch for r in ring.spans(marks[2])] == [2, 3, 4, 5]  # nothing of it lost
    assert [r.batch for r in ring.spans(marks[3], marks[5])] == [3, 4]
    with pytest.raises(SpansLost):
        ring.spans(marks[1])  # span 1 ended after this, and is gone
    with pytest.raises(SpansLost):
        ring.spans(0)


def test_profiler_events_nest_as_the_spans_and_none_outside_a_profile():
    t0 = time.perf_counter_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("graph.replay"):
            with span("feed.slot_wait"):
                torch.ones(4).sum()
    with span("feed.wait"):  # after the profile: the ring only
        pass
    events = {e.name: e for e in prof.events() if e.name.startswith("sivae.")}
    assert set(events) == {"sivae.graph.replay", "sivae.feed.slot_wait"}
    assert events["sivae.feed.slot_wait"].cpu_parent.name == "sivae.graph.replay"
    assert [r.name for r in _mine(t0)] == ["feed.slot_wait", "graph.replay", "feed.wait"]

    with profile(activities=[ProfilerActivity.CPU]) as quiet:
        torch.ones(4).sum()
    assert not [e for e in quiet.events() if e.name.startswith("sivae.")]


def test_prefetch_records_produce_put_and_wait_per_batch():
    t0 = time.perf_counter_ns()
    fed = list(device_prefetch((np.full(3, i) for i in range(5)), size=2,
                              put_fn=device_put_fn("cpu")))
    assert [int(b[0]) for b in fed] == list(range(5))
    recs = [r for r in profiling.spans(t0) if r.name.startswith("feed.")]
    by = {n: sorted(r.batch for r in recs if r.name == n)
          for n in ("feed.produce", "feed.put", "feed.wait")}
    # each batch's own, and the stream's end: one more next and one more wait
    assert by == {"feed.produce": list(range(6)), "feed.put": list(range(5)),
                  "feed.wait": list(range(6))}
    worker = {r.thread for r in recs if r.name in ("feed.produce", "feed.put")}
    assert len(worker) == 1 and threading.get_ident() not in worker
    assert {r.thread for r in recs if r.name == "feed.wait"} == {threading.get_ident()}


def test_a_slow_producer_shows_in_the_loops_wait_not_in_the_put():
    def slow():
        for i in range(4):
            time.sleep(0.05)
            yield np.full(2, i)

    t0 = time.perf_counter_ns()
    assert len(list(device_prefetch(slow(), size=2, put_fn=device_put_fn("cpu")))) == 4
    recs = [r for r in profiling.spans(t0) if r.name.startswith("feed.")]

    def total(name):
        return sum(r.dur_ns for r in recs if r.name == name) / 1e9

    assert total("feed.produce") >= 0.2
    assert total("feed.wait") >= 0.15  # the loop waits for all but the overlap
    assert total("feed.put") < 0.05


class _SlowReady(Transfer):
    """A transfer whose hand-off to the consumer's stream takes 20 ms."""

    def ready(self):
        time.sleep(0.02)
        return self.tensor


def test_the_loops_wait_holds_the_hand_off_to_its_stream():
    t0 = time.perf_counter_ns()
    fed = list(device_prefetch((np.full(2, i) for i in range(3)), size=2,
                               put_fn=lambda b: _SlowReady(torch.from_numpy(b), None)))
    assert [int(b[0]) for b in fed] == [0, 1, 2]
    waits = [r for r in _mine(t0, ("feed.wait",))]
    assert len(waits) == 4  # three batches and the stream's end
    assert sum(r.dur_ns for r in waits) >= 3 * 0.02e9


class _Event:
    """A copy's event: ``synchronize`` takes 10 ms."""

    def synchronize(self):
        time.sleep(0.01)


def test_a_pinned_slot_in_use_waits_inside_a_slot_wait_span():
    t0 = time.perf_counter_ns()
    rings = HostRings(slots=2, pin=False)
    for _ in range(2):  # each slot's first use: nothing to wait for
        rings.slot((3,), np.uint8)[1] = _Event()
    assert not _mine(t0, ("feed.slot_wait",))
    with span("feed.put"):
        rings.slot((3,), np.uint8)
    wait, put = _mine(t0, ("feed.slot_wait", "feed.put"))
    assert wait.parent == put.id and wait.dur_ns >= 0.01e9
    assert put.self_ns < put.dur_ns - 0.01e9 + 0.005e9


def test_a_kernel_build_is_a_span_and_a_built_one_is_not(tmp_path, monkeypatch):
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    out = str(tmp_path / "libfake.so")
    t0 = time.perf_counter_ns()
    with span("graph.warmup"):
        cuda_build._build_all([(lambda tmp: ["touch", tmp], out)])
        cuda_build._build_all([(lambda tmp: ["touch", tmp], out)])  # built: nothing to do
    build, warm = _mine(t0, ("kernels.build", "graph.warmup"))
    assert build.parent == warm.id and warm.self_ns == warm.dur_ns - build.dur_ns
    assert (tmp_path / "libfake.so").exists()


class _State:
    def __init__(self, device):
        self.w = torch.zeros(4, device=device)
        self.generator = torch.Generator(device)
        self.generator.manual_seed(0)
        self.step = 0


def _toy_step(state, x):
    state.w.add_(x.mean(0))
    state.step += 1
    return state, {"loss": state.w.sum()}


def test_an_eager_graph_route_records_no_graph_spans():
    """On the CPU ``one_step`` runs the step itself: no warm-up, capture or
    replay to record."""
    t0 = time.perf_counter_ns()
    step, state = one_step(_toy_step), _State("cpu")
    for _ in range(5):
        state, _ = step(state, torch.ones(2, 4))
    assert not _mine(t0, ("graph.warmup", "graph.capture", "graph.replay"))


def replay_launches(events) -> list:
    """For each ``sivae.graph.replay`` event of a profile's kineto events:
    (the number of ``cudaGraphLaunch`` events inside it, microseconds from
    the event's start to the first device operation of its launch, matched
    by correlation id; None where none was found)."""
    cuda = torch.autograd.DeviceType.CUDA
    host, first = [], {}
    for e in events:
        if e.device_type() == cuda:
            corr = e.correlation_id()  # the launching call's (not the linked op's: another id space)
            if corr:
                first[corr] = min(first.get(corr, e.start_ns()), e.start_ns())
        else:
            host.append((e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
                         e.correlation_id()))
    launches = [h for h in host if h[0].startswith("cudaGraphLaunch")]
    rows = []
    for name, s, t, _ in host:
        if name != "sivae.graph.replay":
            continue
        inside = [la for la in launches if s <= la[1] and la[2] <= t]
        ops = [first[la[3]] for la in inside if la[3] in first]
        rows.append((len(inside), (min(ops) - s) / 1e3 if ops else None))
    return rows


@pytest.mark.cuda
def test_a_graphed_step_records_warmup_capture_replay_and_holds_its_launch(cuda_device):  # noqa: F811
    t0 = time.perf_counter_ns()
    step, state = one_step(_toy_step), _State(cuda_device)
    x = torch.ones(2, 4, device=cuda_device)
    for _ in range(WARMUP_STEPS + 3):
        state, _ = step(state, x)
    torch.cuda.synchronize()
    order = [r.name for r in sorted(_mine(t0, ("graph.warmup", "graph.capture", "graph.replay")),
                                    key=lambda r: r.start_ns)]
    assert order == ["graph.warmup"] * WARMUP_STEPS + ["graph.capture"] + ["graph.replay"] * 3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            state, _ = step(state, x)
        torch.cuda.synchronize()
    rows = replay_launches(list(prof.profiler.kineto_results.events()))
    assert len(rows) == 4
    assert all(n == 1 and lead is not None and lead > 0 for n, lead in rows), rows
