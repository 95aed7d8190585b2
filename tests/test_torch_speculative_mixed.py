"""Port vs reference, the speculative device decoder on a wrong
out_size (len + 1, len - 1): a level-6 stream of 40,000 bytes of word
text with 20,000 random bytes in the middle.  The case and its check
are tests/test_torch_speculative.py's."""
import pytest

from test_torch_speculative import CASES, check_speculative_case
from torch_helpers import jax_native_lib


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    jax_native_lib()


@pytest.mark.parametrize("name", [n for n in CASES
                                  if n.startswith("mixed")])
def test_mixed_stream_wrong_size_matches_reference(name, monkeypatch):
    check_speculative_case(name, monkeypatch)
