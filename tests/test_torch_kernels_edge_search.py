"""The edge cases of ``bsearch`` (``torch_kernel_cases.EDGE_CASES``): the
port's plain version against ``repro``'s reference on the CPU, and the CUDA
kernel against its plain version on the card."""
import pytest

from torch_kernel_cases import (EDGE_FILES, check_cuda_edge, check_edge,  # noqa: F401
                                cuda_device, edge_names)

CASES = edge_names(EDGE_FILES["search"])


@pytest.mark.parametrize("case", CASES)
def test_edge_case_plain_matches_repro(case):
    check_edge(case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_cuda_edge_case_matches_plain(cuda_device, case):
    check_cuda_edge(cuda_device, case)
