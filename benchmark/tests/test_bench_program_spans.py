"""The readers of the program's own spans (``feed.loop_wait_share``,
``feed.busy_share``, ``step.capture_s``, ``device.host_idle_share``) on a
hand-made run: a ring of spans laid out by hand, and a hand-made trace."""

import random

import pytest

from benchmark.core import harness
from benchmark.core.timing import Trace
from soft_intro_vae_torch.utils import profiling

LOOP, WORKER = 1, 2
S = 10 ** 9  # ns a second


class _Window:
    def __init__(self, t0, seconds):
        self.t0, self.seconds, self.t1 = t0, seconds, t0 + seconds


def _run(trace=None, t0=100.0, seconds=10.0, setup_s=20.0):
    return harness.Run(window=_Window(t0, seconds), trace=trace, setup_s=setup_s)


@pytest.fixture
def ring(monkeypatch):
    """A ring of the program's own, and ``add(name, start_s, end_s, ...)``."""
    r = profiling.SpanRing(size=64)
    monkeypatch.setattr(profiling, "RING", r)
    ids = iter(range(10 ** 6))

    def add(name, start, end, thread=LOOP, parent=None, batch=None, child=0.0, id=None):
        i = next(ids) if id is None else id
        r.append((name, thread, round(start * S), round(end * S), i, parent, batch,
                  round(child * S)))
        return i

    add.ring = r
    return add


def _trace(ops, host, seconds):
    """``ops``: (start_us, dur_us) device operations; ``host``: (name, start_us,
    dur_us) host events."""
    tr = Trace()
    tr.ops = [("kernel", s, d) for s, d in ops]
    tr.host = list(host)
    tr.seconds = seconds
    return tr


def test_loop_wait_share_sums_the_waits_inside_the_window(ring):
    ring("feed.wait", 99.0, 101.0)       # 1 s of it inside
    ring("feed.wait", 104.0, 104.5)
    ring("feed.wait", 109.8, 110.4)      # 0.2 s inside
    ring("feed.put", 102.0, 103.0, WORKER)
    got = harness.load_reader("feed.loop_wait_share")(_run())
    assert got == pytest.approx(100.0 * 1.7 / 10.0)


def test_busy_share_takes_the_slot_waits_out_of_the_puts(ring):
    ring("feed.produce", 101.0, 102.0, WORKER, batch=0)
    ring("feed.slot_wait", 102.5, 103.0, WORKER, parent=1000)  # closes before its put
    ring("feed.launch", 103.0, 103.25, WORKER, parent=1000)    # its CUDA calls, blocked
    ring("feed.put", 102.0, 103.5, WORKER, batch=0, child=0.75, id=1000)
    ring("feed.produce", 109.5, 110.5, WORKER, batch=1)   # half inside
    ring("feed.wait", 103.5, 104.0)                       # the loop's: not the feed's work
    got = harness.load_reader("feed.busy_share")(_run())
    assert got == pytest.approx(100.0 * (1.0 + 0.75 + 0.5) / 10.0)


def test_busy_share_counts_a_puts_self_time_in_its_share_inside_the_window(ring):
    ring("feed.put", 99.0, 101.0, WORKER, child=1.0)   # 1 s of own time, half inside
    ring("feed.put", 109.0, 111.0, WORKER, child=2.0)  # all of it waits in children
    got = harness.load_reader("feed.busy_share")(_run())
    assert got == pytest.approx(100.0 * 0.5 / 10.0)


def test_capture_s_is_warmup_and_capture_before_the_window(ring):
    for k in range(3):
        ring("graph.warmup", 90.0 + k, 90.5 + k)
    ring("graph.capture", 93.0, 93.25)
    ring("graph.replay", 93.25, 93.26)
    ring("graph.warmup", 105.0, 106.0)   # a graph warmed in the window: not set-up
    assert harness.load_reader("step.capture_s")(_run()) == pytest.approx(1.75)


def test_capture_s_leaves_out_a_kernel_build_inside_the_first_warmup(ring):
    ring("kernels.build", 80.2, 89.2, parent=7)
    ring("graph.warmup", 80.0, 89.5, child=9.0, id=7)   # 0.5 s of its own
    for k in range(1, 3):
        ring("graph.warmup", 90.0 + k, 90.5 + k)
    ring("graph.capture", 93.0, 93.25)
    assert harness.load_reader("step.capture_s")(_run()) == pytest.approx(1.75)


@pytest.mark.parametrize("name", ["feed.loop_wait_share", "feed.busy_share", "step.capture_s"])
def test_ring_readers_read_nothing_without_spans_or_past_the_ring(ring, monkeypatch, name):
    # a program without spans: nothing to read
    assert harness.load_reader(name)(_run()) is None
    # a ring that has dropped records of the stretch read
    for k in range(70):
        ring("feed.wait", 100.0 + k * 0.1, 100.05 + k * 0.1)
        ring("feed.produce", 100.0 + k * 0.1, 100.05 + k * 0.1, WORKER)
        ring("graph.warmup", 90.0 + k * 0.01, 90.005 + k * 0.01)
    assert harness.load_reader(name)(_run()) is None
    # a checkout whose program has no span ring at all
    monkeypatch.delattr(profiling, "spans")
    assert harness.load_reader(name)(_run()) is None


def _graph_trace():
    """Two steps of one graph of two ops each, each a replay span whose
    ``cudaGraphLaunch`` blocks until the previous replay has ended:

    - ops 100-150, 160-210 (step 1) and 1000-1050, 1060-1110 (step 2): gaps
      150-160 and 1050-1060 inside a graph, 210-1000 between the two;
    - step 1's replay span 60-120, its launch 70-75 (before the first op);
    - step 2's replay span 130-1050, opened while step 1 runs, its launch
      blocked 140-990: it returns inside the 210-1000 gap;
    - the loop's wait on the feed, 300-800: not a launching span.
    """
    ops = [(100, 50), (160, 50), (1000, 50), (1060, 50)]
    host = [("sivae.graph.replay", 60, 60), ("cudaGraphLaunch", 70, 5),
            ("sivae.graph.replay", 130, 920), ("cudaGraphLaunch", 140, 850),
            ("sivae.feed.wait", 300, 500), ("cudaEventRecord", 400, 2)]
    return _trace(ops, host, seconds=1200e-6)


def test_host_idle_counts_gaps_in_which_a_launch_returns(ring):
    tr = _graph_trace()
    assert [g for g in tr.gaps()] == [(150, 10), (210, 790), (1050, 10)]
    got = harness.load_reader("device.host_idle_share")(_run(tr))
    # the 210-1000 gap: step 2's launch, made in its replay span, returns in
    # it; the 150-160 gap lies under that span too, but no call returns in
    # it; the 1050-1060 gap has no launching span open; the event record in
    # the loop's wait is no launching span's
    assert got == pytest.approx(100.0 * 790e-6 / 1200e-6)
    assert got <= harness.load_reader("device.idle_share")(_run(tr))


def test_a_gap_under_a_launching_span_alone_does_not_count(ring):
    ops = [(0, 10), (20, 10)]
    host = [("sivae.graph.replay", 0, 40), ("cudaGraphLaunch", 1, 35)]  # returns after the gap
    tr = _trace(ops, host, 40e-6)
    assert harness.load_reader("device.host_idle_share")(_run(tr)) == 0.0


def test_host_idle_reads_nothing_without_launching_spans(ring):
    tr = _trace([(0, 10), (50, 10)], [("bench.step", 0, 60), ("cudaLaunchKernel", 20, 5)],
                100e-6)
    assert harness.load_reader("device.host_idle_share")(_run(tr)) is None
    assert harness.load_reader("device.host_idle_share")(_run(None)) is None


def test_host_idle_takes_the_workers_puts_from_the_ring_on_the_traces_clock(ring):
    """The worker's put reaches the ring only; the offset between the ring's
    clock and the trace's comes from the replays both hold. A copy the put
    makes returns in the second graph's inner gap (1050-1060 us), after the
    loop's replay span has closed."""
    tr = _graph_trace()
    tr.host.append(("cudaMemcpyAsync", 1048, 7))   # 1048-1055, on the worker
    t1 = 100.0 + 10.0   # the window's end: the stretch's spans come after it
    base = t1 + 5.0      # the trace's 0 us on the ring's clock
    for s, e in ((60, 120), (130, 1050)):  # the same replays, on the ring's clock
        ring("graph.replay", base + (s + 2) * 1e-6, base + (e - 2) * 1e-6)
    assert harness.load_reader("device.host_idle_share")(_run(tr)) == pytest.approx(
        100.0 * 790e-6 / 1200e-6)  # no put yet: the copy is no launching span's
    ring("feed.put", base + 1046e-6, base + 1058e-6, WORKER)
    got = harness.load_reader("device.host_idle_share")(_run(tr))
    assert got == pytest.approx(100.0 * 800e-6 / 1200e-6)


@pytest.mark.parametrize("seed", range(20))
def test_host_idle_never_exceeds_the_idle_share(ring, seed):
    rnd = random.Random(seed)
    ops, t = [], 0.0
    for _ in range(60):
        t += rnd.choice([0.0, rnd.uniform(0, 30)])
        d = rnd.uniform(1, 40)
        ops.append((t, d))
        t += d * rnd.choice([0.5, 1.0])   # some ops overlap the next
    names = ["sivae.graph.replay", "sivae.graph.warmup", "sivae.feed.put", "sivae.feed.wait",
             "cudaGraphLaunch", "cudaMemcpyAsync", "cuLaunchKernel"]
    host = [(rnd.choice(names), rnd.uniform(0, t), rnd.uniform(1, 200)) for _ in range(40)]
    tr = _trace(ops, host, seconds=(t + rnd.uniform(0, 50)) * 1e-6)
    got = harness.load_reader("device.host_idle_share")(_run(tr))
    idle = harness.load_reader("device.idle_share")(_run(tr))
    if got is not None:
        assert 0.0 <= got <= idle + 1e-9
