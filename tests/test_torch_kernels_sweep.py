"""The four sweeps of every kernel's registered case
(``torch_kernel_cases.KERNEL_CASES``): the port's plain version against
``repro``'s reference and Pallas kernel (interpret mode) on the CPU, and the
CUDA kernel against its plain version on the card."""
import pytest

from torch_kernel_cases import (KERNEL_CASES, check_cuda_sweep, check_sweep,  # noqa: F401
                                cuda_device)


@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
@pytest.mark.parametrize("sweep", range(4))
def test_plain_matches_repro_ref_and_kernel(name, sweep):
    check_sweep(name, sweep)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(KERNEL_CASES))
@pytest.mark.parametrize("sweep", range(4))
def test_cuda_kernel_matches_plain(cuda_device, name, sweep):
    check_cuda_sweep(cuda_device, name, sweep)
