"""Port vs reference, kernel K3's plain version (monotone routing):
route_plain equals deflate_tpu's route_monotone_left / _right on the
slots where an element lands (and holds payload 0, dout -1 elsewhere) on
one to three payloads, both directions, routed lengths that are not a
multiple of 4, deltas at and above 2**rounds (not routed), rows without
an element and the encoder's packet compaction; and equals route_pallas
(interpret mode) where the routed length is a multiple of 1024."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deflate_tpu.ops import wave as JW
from deflate_tpu.ops.wave_route import route_pallas
from deflate_tpu_torch.ops import wave_route as WR
from torch_helpers import ROUTE_CASES, assert_same, route_case

CASES = [pytest.param(*c[1:], id=c[0]) for c in ROUTE_CASES]


def _plain(pays, delta, rounds, left):
    return WR.route_plain([torch.from_numpy(p) for p in pays],
                          torch.from_numpy(delta), rounds, left)


def _check(got, landed, want_pays):
    gp, gd = got
    assert_same(gd, np.where(landed, 0, -1), "dout")
    for g, w in zip(gp, want_pays):
        assert_same(g, np.where(landed, np.asarray(w), 0), "payload")


@pytest.mark.parametrize("P,left,B,L,rounds,kind", CASES)
def test_k3_plain_matches_route_monotone(P, left, B, L, rounds, kind):
    pays, delta = route_case(P + 10 * B, P, left, B, L, rounds, kind)
    fn = JW.route_monotone_left if left else JW.route_monotone_right
    jp, jd = fn([jnp.asarray(p) for p in pays], jnp.asarray(delta), rounds)
    landed = np.asarray(jd) == 0
    assert not landed[0].any() and landed[1:].any()
    _check(_plain(pays, delta, rounds, left), landed, jp)


@pytest.mark.parametrize("P,left,B,L,rounds,kind",
                         [c for c in CASES if c.values[3] % 1024 == 0])
def test_k3_plain_matches_route_pallas(P, left, B, L, rounds, kind):
    pays, delta = route_case(P + 10 * B, P, left, B, L, rounds, kind)
    jp, jd = route_pallas([jnp.asarray(p) for p in pays], jnp.asarray(delta),
                          rounds, left=left, interpret=True)
    _check(_plain(pays, delta, rounds, left), np.asarray(jd) == 0, jp)
