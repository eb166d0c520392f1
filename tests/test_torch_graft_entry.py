"""``pandepth_tpu_torch.graft_entry``, the port's twin of
``__graft_entry__.py``, on the CPU: its tiny problem is the JAX entry's,
``entry(device="cpu")``'s step is array-equal to JAX's ``entry()``,
``dryrun_multichip`` over 2 and 4 gloo ranks matches the JAX
``coverage_step`` on all the reads, and a rank that fails or hangs makes
the call raise, not hang."""

import time

import numpy as np
import pytest

import __graft_entry__ as jax_graft
from pandepth_tpu.device.step import coverage_step as jax_step

from pandepth_tpu_torch import graft_entry


def test_tiny_problem_is_the_jax_entrys():
    for n_reads, n_ops in ((64, 128), (16, 32)):
        layout, cols, (lo, hi) = graft_entry.tiny_problem(n_reads, n_ops)
        jlayout, jargs, _ = jax_graft._tiny_problem(n_reads, n_ops)
        want = [np.asarray(a) for a in jargs]
        got = [*cols, layout.offsets, layout.limits, lo, hi]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
        np.testing.assert_array_equal(layout.offsets, jlayout.offsets)


def test_entry_matches_jax():
    jfn, jargs = jax_graft.entry()
    fn, args = graft_entry.entry(device="cpu")
    assert [str(a.device) for a in args] == ["cpu"] * 11
    for g, w in zip(fn(*args), jfn(*jargs)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip_cpu(n):
    t0 = time.monotonic()
    got = graft_entry.dryrun_multichip(n, device="cpu", seconds=240)
    assert time.monotonic() - t0 < 240
    assert got["backend"] == "gloo" and got["devices"] == ["cpu"] * n
    _, jargs, _ = jax_graft._tiny_problem(n_reads=8 * n, n_ops=16 * n)
    want = jax_step(*jargs, flags_mask=1796, min_mapq=-1, min_dep=1)
    np.testing.assert_array_equal(got["cover"], np.asarray(want[0]))
    np.testing.assert_array_equal(got["dsum"], np.asarray(want[1]))
    assert got["cover"].sum() > 0


def _failing_rank(n, rank, backend, device, store, out):
    """Rank 1 fails at once; rank 0 waits as if in a collective."""
    if rank == 1:
        raise RuntimeError("this rank fails")
    time.sleep(600)


def _hanging_rank(n, rank, backend, device, store, out):
    time.sleep(600)


@pytest.mark.parametrize("target,seconds,why", [
    (_failing_rank, 120, "rank 1 exited 1"),
    (_hanging_rank, 10, "passed 10 s")])
def test_dryrun_rank_failure_raises(monkeypatch, target, seconds, why):
    monkeypatch.setattr(graft_entry, "_rank", target)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=why):
        graft_entry.dryrun_multichip(2, device="cpu", seconds=seconds)
    assert time.monotonic() - t0 < 90
