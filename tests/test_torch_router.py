"""The port's KV-aware router (``repro_torch.serving.router``).

Against the reference: the port's ``KVRouter`` copy and the reference's,
driven by one scripted sequence of placements, completions, migrations
and direct-to-decode notes over stub workers (their ``prefix_match_len``
scripted too), give equal placements and equal ``snapshot()``s after
every step. The reference's own router cases (``tests/test_disagg.py``)
run on the port: the depth clamp and the validation.
"""
import pytest

from repro.serving.router import KVRouter as JKVRouter
from repro_torch.serving.router import KVRouter


class _Worker:
    """A prefill worker whose radix tree holds ``cached`` token prefixes."""

    def __init__(self, cached=()):
        self.cached = [list(c) for c in cached]

    def prefix_match_len(self, prompt):
        best = 0
        for c in self.cached:
            n = 0
            while n < min(len(c), len(prompt)) and c[n] == prompt[n]:
                n += 1
            best = max(best, n)
        return best


def _script(router_cls):
    """One scripted sequence; returns what each step returned and the
    snapshot after it."""
    A, B = list(range(16)), list(range(100, 116))
    pw = [_Worker([A]), _Worker(), _Worker([B[:8], A[:4]])]
    r = router_cls(pw, [object(), object()])
    steps = [
        lambda: r.pick_prefill(A + [7, 7]),      # overlap: worker 0
        lambda: r.pick_prefill([9, 9, 9]),       # ties at 0: shallowest
        lambda: r.pick_prefill(B + [1]),         # worker 2's 8 tokens
        lambda: r.pick_prefill([5]),             # every depth 1: lowest
        lambda: r.pick_decode(),
        lambda: r.pick_decode(),
        lambda: r.pick_decode(),
        lambda: r.note_prefill_done(0),
        lambda: r.note_prefill_done(0),
        lambda: r.note_prefill_done(0),          # an underflow, clamped
        lambda: r.note_migrated(1, 5),
        lambda: r.note_migrated(0, 2),
        lambda: r.note_direct_decode(),
        lambda: r.note_decode_done(0),
        lambda: r.note_decode_done(1),
        lambda: r.note_decode_done(1),           # another underflow
        lambda: r.pick_decode(),
        lambda: r.pick_prefill(A[:10]),
    ]
    return [(step(), r.snapshot()) for step in steps]


def test_router_matches_reference_on_a_script():
    got, want = _script(KVRouter), _script(JKVRouter)
    assert got == want
    last = got[-1][1]
    assert last["depth_underflows"] == 2 and last["migrated_pages_total"] == 7
    assert last["prefill_overlap_hits"][0] >= 1


def test_router_validation():
    with pytest.raises(ValueError, match="router needs"):
        KVRouter([], [object()])
    with pytest.raises(ValueError, match="router needs"):
        KVRouter([_Worker()], [])


def test_router_depth_clamps_at_zero():
    """A double done (or a done with no matching pick) must not drive a
    depth negative, which would make that worker win every least-loaded
    tie from then on: depths clamp at 0 and count in
    ``depth_underflows``."""
    r = KVRouter([_Worker(), _Worker()], [object(), object()])
    w = r.pick_prefill([1, 2, 3])
    r.note_prefill_done(w)
    r.note_prefill_done(w)
    r.note_decode_done(1)
    snap = r.snapshot()
    assert snap["prefill_queue_depth"] == [0, 0]
    assert snap["decode_queue_depth"] == [0, 0]
    assert snap["depth_underflows"] == 2
    d = r.pick_decode()
    assert d == 0                       # the lowest index, not the clamped 1
    r.note_decode_done(d)
    assert r.snapshot()["depth_underflows"] == 2
