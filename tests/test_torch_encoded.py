"""The encoded-window finalize (K8): pandepth_tpu_torch's
``finalize_encoded`` and its decoders (on the CPU, the plain twins of the
``decode_enc`` kernel) against pandepth_tpu.device.sweep.finalize_encoded
and the host decoder ``hosteval.decode_enc_host``, on seeded windows.

Tolerance: exact equality (all arithmetic is integer). The windows cover
all four code groups, escapes in both planes of the mixed format and in
the delta plane of the const format, zero rows, partial rows, JAX's tiny
placeholder block for an unused group, raw chunks with sentinel tails,
and deltas that wrap the 32-bit tiers' arithmetic.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pandepth_tpu.device import sweep as jsweep
from pandepth_tpu.device.hosteval import decode_enc_host
from pandepth_tpu_torch.device import sweep
from pandepth_tpu_torch.device.convert import (codes_to_torch,
                                               enc_group_from_numpy,
                                               positions_to_words,
                                               state_to_numpy)
from pandepth_tpu_torch.synth import enc_group, enc_placeholder

# the position tiers: numpy dtype and the genome span their windows cover
TIERS = {"int32": (np.int32, 2_000_000_000),
         "uint32": (np.uint32, 4_200_000_000),
         "int64": (np.int64, 17_000_000_000)}
CAP, CE, B = 96, 10, 3


def _group(rng, code_dt, pos_dt, span, const, rows_per_block=(B, B),
           dense=False):
    """A group whose windows lie anywhere below ``span``, or (``dense``)
    all in one 3 kb stretch near its top, where the groups' events share
    positions, so their order shows in the sweep state."""
    lo, hi = (span - 60_000, span - 57_000) if dense else \
        (10_000, span - 100_000)
    return enc_group(rng, code_dt, pos_dt, lo, hi, const, rows_per_block,
                     CAP, CE)


def _raw(rng, pos_dt, span, n=200, tail=13):
    sentinel = int(np.iinfo(pos_dt).max)
    s = rng.randint(0, span - 1000, n).astype(np.int64)
    e = s + rng.randint(0, 500, n)
    s = np.concatenate([s, np.full(tail, sentinel, np.int64)]).astype(pos_dt)
    e = np.concatenate([e, np.full(tail, sentinel, np.int64)]).astype(pos_dt)
    pos = np.concatenate([s, e])
    delta = np.concatenate([(s < sentinel).astype(np.int32),
                            -(e < sentinel).astype(np.int32)])
    return pos, delta


def _operands(tier, seed, placeholder_g16=False):
    pos_dt, span = TIERS[tier]
    rng = np.random.RandomState(seed)
    g8, _ = _group(rng, np.uint8, pos_dt, span, False, dense=True)
    g16 = enc_placeholder(np.uint16, pos_dt, False) if placeholder_g16 \
        else _group(rng, np.uint16, pos_dt, span, False, (B, 2),
                    dense=True)[0]
    gc8, _ = _group(rng, np.uint8, pos_dt, span, True, (2,), dense=True)
    gc16, _ = _group(rng, np.uint16, pos_dt, span, True, (B, B, 1))
    raws = [_raw(rng, pos_dt, span), _raw(rng, pos_dt, span, n=50, tail=0)]
    q = np.sort(np.concatenate([rng.randint(0, span, 300),
                                rng.randint(span - 61_000, span - 55_000,
                                            100)]))
    return (g8, g16, gc8, gc16), raws, q[0::2].astype(pos_dt), \
        q[1::2].astype(pos_dt)


def _jax(groups, raws, lo, hi, **kw):
    jg = [tuple(tuple(jnp.asarray(b) for b in part) if isinstance(part, tuple)
                else jnp.asarray(part) for part in g) for g in groups]
    return jsweep.finalize_encoded(
        *jg, tuple(jnp.asarray(p) for p, _ in raws),
        tuple(jnp.asarray(d) for _, d in raws), jnp.asarray(lo),
        jnp.asarray(hi), **kw)


def _port(groups, raws, lo, hi, pos_dt, **kw):
    tg = [enc_group_from_numpy(g, pos_dt, "cpu") for g in groups]

    def words(a):
        return torch.from_numpy(positions_to_words(a, pos_dt))

    return sweep.finalize_encoded(
        *tg, [words(p) for p, _ in raws],
        [torch.from_numpy(d) for _, d in raws], words(lo), words(hi),
        pos_max=int(np.iinfo(pos_dt).max), **kw)


def _assert_outputs_equal(got, want, pos_dt):
    assert len(got) == len(want)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if len(got) == 2:
        return
    state = state_to_numpy(*got[2:6], pos_dt)
    for g, w in zip(state, want[2:6]):
        np.testing.assert_array_equal(g, np.asarray(w))
    np.testing.assert_array_equal(got[6].numpy(), np.asarray(want[6]))


@pytest.mark.parametrize("min_dep", [1, 3])
@pytest.mark.parametrize("wrap18", [False, True])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_finalize_encoded_matches_jax(tier, wrap18, min_dep):
    """All 7 outputs (cover, dsum and the sweep state) array-equal."""
    pos_dt = TIERS[tier][0]
    groups, raws, lo, hi = _operands(tier, seed=7 + min_dep + 2 * wrap18)
    kw = dict(min_dep=min_dep, wrap18=wrap18, want_state=True)
    got = _port(groups, raws, lo, hi, pos_dt, **kw)
    _assert_outputs_equal(got, _jax(groups, raws, lo, hi, **kw), pos_dt)
    assert int(got[0].sum()) > 0


@pytest.mark.parametrize("tier", sorted(TIERS))
def test_finalize_encoded_without_state_matches_jax(tier):
    """want_state off: (cover, dsum) only; JAX's placeholder block for an
    unused group; no raw chunks."""
    pos_dt = TIERS[tier][0]
    groups, _, lo, hi = _operands(tier, seed=30, placeholder_g16=True)
    kw = dict(min_dep=1, wrap18=True, want_state=False)
    got = _port(groups, [], lo, hi, pos_dt, **kw)
    _assert_outputs_equal(got, _jax(groups, [], lo, hi, **kw), pos_dt)


def test_finalize_encoded_skips_absent_groups():
    """The port's engine passes None for an empty group: the same answers
    as JAX with its placeholder block (zero-length events, depth-neutral)."""
    pos_dt = np.int32
    groups, raws, lo, hi = _operands("int32", seed=41, placeholder_g16=True)
    tg = [enc_group_from_numpy(g, pos_dt, "cpu") for g in groups]
    got = sweep.finalize_encoded(
        tg[0], None, tg[2], tg[3], [torch.from_numpy(p) for p, _ in raws],
        [torch.from_numpy(d) for _, d in raws], torch.from_numpy(lo),
        torch.from_numpy(hi), want_state=False)
    _assert_outputs_equal(got, _jax(groups, raws, lo, hi, min_dep=1,
                                    want_state=False), pos_dt)


def _host_rows(wins, const):
    """decode_enc_host's answer for each (dd, ll, excd, excl, base, n)
    window; a const window's length plane holds its one length."""
    return [decode_enc_host(dd, ll, excd,
                            np.zeros_like(excl) if const else excl, base, n)
            for dd, ll, excd, excl, base, n in wins]


@pytest.mark.parametrize("const", [False, True], ids=["mixed", "const"])
@pytest.mark.parametrize("code_dt", [np.uint8, np.uint16],
                         ids=["u8", "u16"])
@pytest.mark.parametrize("tier", sorted(TIERS))
def test_decoders_match_host_decoder(tier, code_dt, const):
    """Each decoder's twin, row by row, against decode_enc_host on the
    row's live pairs; the tail decodes to zero-length events at the last
    live start (or the base)."""
    pos_dt, span = TIERS[tier]
    rng = np.random.RandomState(50 + const)
    g, wins = _group(rng, code_dt, pos_dt, span, const)
    tg = enc_group_from_numpy(g, pos_dt, "cpu")
    pm = int(np.iinfo(pos_dt).max)
    decode = sweep.decode_const_group if const else sweep.decode_enc_group
    s, e = decode(*tg, pos_max=pm)
    s = s.numpy().astype(np.int64).reshape(-1, CAP)
    e = e.numpy().astype(np.int64).reshape(-1, CAP)
    for r, (hs, he) in enumerate(_host_rows(wins, const)):
        n = hs.shape[0]
        np.testing.assert_array_equal(s[r, :n], hs)
        np.testing.assert_array_equal(e[r, :n], he)
        last = hs[-1] if n else wins[r][4]
        assert (s[r, n:] == last).all() and (e[r, n:] == last).all()


def test_u16_codes_cross_as_int16_bits():
    """uint16 code blocks are carried as their raw int16 bits, never
    widened on the host."""
    c = np.array([0, 1, 40000, 65535], np.uint16)
    t = codes_to_torch(c)
    assert t.dtype == torch.int16 and t.numel() * 2 == c.nbytes
    assert (t.to(torch.int64) & 0xFFFF).tolist() == c.tolist()
