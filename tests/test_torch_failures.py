"""The port's simulated hardware layer (`repro_torch.runtime.failures`)
against the JAX package's (`repro.runtime.failures`), case by case with
`tests/test_failures.py`: each scenario runs on both modules and must give
the pinned answer on the port and the reference's answer, exactly."""
import numpy as np

from repro.runtime import failures as ref
from repro_torch import runtime
from repro_torch.runtime import failures as port


def both(scenario):
    """The scenario's trace on the port, after checking it equals the
    reference's."""
    got, want = scenario(port), scenario(ref)
    assert got == want
    return got


def test_runtime_exports_only_the_three_monitors():
    """The package exports the JAX package's runtime names: the three
    monitors (this module's), gradient compression and the lazily
    imported trainer."""
    import repro.runtime

    assert sorted(runtime.__all__) == sorted(repro.runtime.__all__)
    for name in ("FailureInjector", "HeartbeatMonitor", "StragglerDetector"):
        assert getattr(runtime, name) is getattr(port, name)


# ---------------------------------------------------------------------------
# FailureInjector
# ---------------------------------------------------------------------------
class TestFailureInjector:
    def test_schedule_fires_at_exact_steps(self):
        def run(m):
            inj = m.FailureInjector(schedule={2: [1], 5: [0, 3]})
            return [sorted(inj.tick(s)) for s in range(6)], inj.dead
        ticks, dead = both(run)
        assert ticks == [[], [], [1], [], [], [0, 3]]
        assert dead == {0, 1, 3}

    def test_deterministic_across_instances(self):
        sched = {1: [2], 3: [2, 5], 7: [0]}

        def run(m):
            inj = m.FailureInjector(schedule=dict(sched))
            return [inj.tick(s) for s in range(10)]
        assert both(run) == run(port)

    def test_already_dead_nodes_do_not_die_twice(self):
        def run(m):
            inj = m.FailureInjector(schedule={1: [4], 3: [4, 6]})
            return inj.tick(1), inj.tick(3), inj.dead
        assert both(run) == ([4], [6], {4, 6})

    def test_pre_dead_set_respected(self):
        assert both(lambda m: m.FailureInjector(
            schedule={0: [1, 2]}, dead={1}).tick(0)) == [2]

    def test_skipped_steps_do_not_fire(self):
        def run(m):
            inj = m.FailureInjector(schedule={2: [1]})
            return inj.tick(3), inj.dead
        assert both(run) == ([], set())


# ---------------------------------------------------------------------------
# HeartbeatMonitor
# ---------------------------------------------------------------------------
class TestHeartbeatMonitor:
    def test_timeout_edge_is_strict(self):
        def run(m):
            t = [0.0]
            mon = m.HeartbeatMonitor([0, 1], timeout=10.0,
                                     clock=lambda: t[0])
            t[0] = 10.0
            at_edge = mon.failed_nodes()
            t[0] = 10.0 + 1e-9
            return at_edge, mon.failed_nodes()
        assert both(run) == ([], [0, 1])

    def test_beat_resets_the_clock(self):
        def run(m):
            t = [0.0]
            mon = m.HeartbeatMonitor([0, 1], timeout=5.0, clock=lambda: t[0])
            t[0] = 4.0
            mon.beat(1)
            t[0] = 7.0
            return mon.failed_nodes()
        assert both(run) == [0]

    def test_explicit_at_and_now(self):
        def run(m):
            mon = m.HeartbeatMonitor([3], timeout=2.0, clock=lambda: 0.0)
            mon.beat(3, at=100.0)
            return mon.failed_nodes(now=102.0), mon.failed_nodes(now=102.5)
        assert both(run) == ([], [3])


# ---------------------------------------------------------------------------
# StragglerDetector
# ---------------------------------------------------------------------------
class TestStragglerDetector:
    def test_min_samples_gate(self):
        def run(m):
            det = m.StragglerDetector(threshold=1.5, min_samples=4)
            for n in (0, 2):
                for _ in range(4):
                    det.record(n, 1.0)
            for _ in range(3):
                det.record(1, 100.0)
            short = det.stragglers()
            det.record(1, 100.0)
            return short, det.stragglers()
        assert both(run) == ([], [1])

    def test_needs_two_qualifying_nodes(self):
        def run(m):
            det = m.StragglerDetector(min_samples=2)
            det.record(5, 50.0)
            det.record(5, 50.0)
            return det.stragglers()
        assert both(run) == []

    def test_threshold_relative_to_median(self):
        def run(m, slow):
            det = m.StragglerDetector(threshold=2.0, min_samples=1)
            for n, d in [(0, 1.0), (1, 1.0), (2, slow)]:
                det.record(n, d)
            return det.stragglers()
        assert both(lambda m: run(m, 1.9)) == []
        assert both(lambda m: run(m, 2.1)) == [2]

    def test_window_forgets_old_samples(self):
        def run(m):
            det = m.StragglerDetector(window=4, threshold=1.5, min_samples=4)
            for n in (0, 2):
                for _ in range(4):
                    det.record(n, 1.0)
            for _ in range(4):
                det.record(1, 10.0)
            slow = det.stragglers()
            for _ in range(4):
                det.record(1, 1.0)
            return slow, det.stragglers()
        assert both(run) == ([1], [])

    def test_deterministic(self):
        durs = np.random.default_rng(7).uniform(0.5, 2.0, size=(3, 16))

        def run(m):
            det = m.StragglerDetector(window=8, threshold=1.2, min_samples=4)
            for n in range(3):
                for d in durs[n]:
                    det.record(n, float(d))
            return det.stragglers()
        assert both(run) == both(run)
