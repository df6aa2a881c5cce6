"""The port's streaming path across ranks against ``repro``'s host mesh, at
8 parts (8 gloo ranks and a host mesh of 8 devices), and the fold's
collectives under thread switches.

The cases, the inputs and ``repro``'s side are in
``torch_mesh_waves_cases.py``.
"""
import numpy as np
import pytest

from torch_mesh_waves_cases import build_runs, mesh_wave_tests

PARTS = (8,)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return build_runs(tmp_path_factory, PARTS)


globals().update(mesh_wave_tests(PARTS))


class _CountingMesh:
    """A stand-in mesh whose ``sum_ints`` records the order of its calls
    (as a process group would pair them) and sums over 3 identical ranks."""

    def __init__(self):
        self.calls = []

    def sum_ints(self, *values):
        self.calls.append(values)
        return [3 * v for v in values]


def test_fold_collectives_keep_wave_order_under_thread_switches():
    """The feeder answers the fold thread's requests wave by wave, in the
    order the fold made them, however the two threads interleave (a very
    short switch interval); a failed feeder fails the fold's waiting
    request instead of leaving it blocked."""
    import sys
    import threading
    from repro_torch.pipeline.executor import _FoldCollectives
    mesh = _CountingMesh()
    calls = _FoldCollectives(mesh)
    rng = np.random.default_rng(0)
    asks = [list(rng.integers(0, 1000, rng.integers(0, 4))) for _ in range(300)]
    answers = []

    def fold():
        for wave in asks:
            answers.append([calls.sum_int(int(v)) for v in wave])
            calls.wave_done()

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        folder = threading.Thread(target=fold)
        folder.start()
        for _ in asks:
            calls.serve()
        folder.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not folder.is_alive()
    assert answers == [[3 * v for v in wave] for wave in asks]
    assert mesh.calls == [(int(v),) for wave in asks for v in wave]

    failing = _FoldCollectives(mesh)
    errors = []

    def ask():
        try:
            failing.sum_int(1)
        except RuntimeError as e:
            errors.append(e)

    waiter = threading.Thread(target=ask)
    waiter.start()
    while failing._requests.empty():
        threading.Event().wait(0.001)
    failing.close(OSError("collective failed"))
    waiter.join(timeout=60)
    assert not waiter.is_alive() and isinstance(errors[0].__cause__, OSError)
    with pytest.raises(RuntimeError):
        failing.sum_int(2)
