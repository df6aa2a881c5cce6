"""The port's streaming path across ranks against ``repro``'s host mesh, at
3 parts (3 gloo ranks and a host mesh of 3 devices).

The cases, the inputs and ``repro``'s side are in
``torch_mesh_waves_cases.py``.
"""
import pytest

from torch_mesh_waves_cases import build_runs, mesh_wave_tests

PARTS = (3,)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return build_runs(tmp_path_factory, PARTS)


globals().update(mesh_wave_tests(PARTS))
