"""Port vs reference, the speculative device decoder on a wrong
out_size (len + 1, len - 1): zlib level 9 and level 6 Z_FILTERED
streams of a 60,000-byte word text.  The cases and their
check are tests/test_torch_speculative.py's."""
import pytest

from test_torch_speculative import CASES, check_speculative_case
from torch_helpers import jax_native_lib


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    jax_native_lib()


@pytest.mark.parametrize("name", [n for n in CASES if n.startswith(
    ("level9", "filtered"))])
def test_wrong_size_cases_match_reference(name, monkeypatch):
    check_speculative_case(name, monkeypatch)
