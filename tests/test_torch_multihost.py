"""The port's multi-process slice (K10) on the CPU against the JAX
package's: ``pandepth_tpu_torch.sharding.{mesh,multihost,launch}`` run in
gloo jobs of 1, 2 and 4 worker processes (each imports only torch, numpy
and the port, joins through a ``file://`` store under the test's
directory, and runs every case of its world size; a job has 120 s, and
when one rank fails or the time runs out every rank is killed), while the
JAX side runs in this process on its 8 virtual CPU devices, a flat mesh
of as many devices as the job has ranks, row i holding rank i's data:

- ``bucket_events_reference`` against numpy on every position tier
  (``TIERS`` of test_torch_sharding.py) with dead slots, a hot range,
  empty ranges and an event at ``layout.total``; on each rank the events
  ``bucket_exchange`` received, in order, against JAX's
  ``_bucket_exchange`` under ``shard_map`` (its received rows with each
  source's padding removed), and the carry;
- the exchange finalize (``exchange_sorted`` + ``state_eval``) against
  ``_events_exchange_finalize``: each rank's sweep state on its first
  1 + received slots and (cover, dsum), wrap18 on and off, min_dep 1 and
  2, a carry past int32;
- ``sharded_coverage_step`` against JAX's on the same reads;
- ``MultihostCoverageEngine`` against JAX's and the single-device engine:
  one exchange per feed, the state kept for later calls and chunks, a feed
  on one rank rebuilding it on every rank;
- the CLI through ``python -m pandepth_tpu_torch.sharding.launch`` on 2
  ranks: rank 0's table byte-equal to the port's and the JAX package's
  single-process CLI, and rank 1 writes none. The run is decided on the
  whole list (a deep 2-file ``.list`` whose pooled depth passes 2^18
  wraps as the single-process run does), and a rank with no file joins.

Tolerance: none, every output is array-equal or byte-equal (all
arithmetic is integer).
"""

import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from pandepth_tpu.cli import main as jax_main
from pandepth_tpu.device.engine import CoverageEngine as JaxEngine
from pandepth_tpu.device.layout import GenomeLayout
from pandepth_tpu.io.bam import ReadBatch
from pandepth_tpu.sharding import mesh as jax_mesh
from pandepth_tpu.sharding.multihost import \
    MultihostCoverageEngine as JaxMultihost
from pandepth_tpu_torch import synth
from pandepth_tpu_torch.cli import main as port_main
from pandepth_tpu_torch.device import kernels
from pandepth_tpu_torch.io import native
from pandepth_tpu_torch.io.bam_writer import write_uniform_bam
from pandepth_tpu_torch.sharding import distributed, mesh
from tests.fixtures import gunzip_bytes, make_bam, make_bed
from tests.test_torch_sharding import TIERS, _segments

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (1, 2, 4)
TIER_OF = {"int32": (np.int32, kernels.TIER_I32),
           "uint32": (np.uint32, kernels.TIER_U32),
           "int64": (np.int64, kernels.TIER_I64)}
# (wrap18, min_dep) of the finalize on each event set; the hot set's
# carry passes int32
VARIANTS = {"random": [(False, 1), (True, 2)], "hot": [(True, 1), (False, 2)]}
JOB_SECONDS = 120

# A rank of a job: argv = world, rank, case directory. Reads cases.json
# and each case's inputs (in_<case>.npz), writes out_<case>_r<rank>.npz.
WORKER = r"""
import json, os, sys
import numpy as np
import torch
import torch.distributed as dist

from pandepth_tpu_torch.device.layout import GenomeLayout
from pandepth_tpu_torch.sharding import mesh
from pandepth_tpu_torch.sharding.distributed import init_multihost
from pandepth_tpu_torch.sharding.multihost import MultihostCoverageEngine

world, rank, d = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
torch.set_num_threads(1)
with open(os.path.join(d, "cases.json")) as fh:
    cases = json.load(fh)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def exchange(x):
    pos, delta, bounds = t(x[f"pos{rank}"]), t(x[f"delta{rank}"]), t(x["bounds"])
    tier = int(x["tier"])
    out = {}
    lp, ld, counts, sums = mesh.bucket_events(pos, delta, bounds, tier)
    n = int(counts.sum())
    out.update(local_pos=lp[:n], local_delta=ld[:n], counts=counts,
               sums=sums)
    for k, (wrap18, min_dep) in enumerate(x["variants"].tolist()):
        state, row_bounds, ex = mesh.exchange_sorted(
            pos, delta, bounds, tier, int(min_dep), bool(wrap18),
            int(x["pos_max"]))
        cover, dsum = mesh.state_eval(state, row_bounds, int(min_dep),
                                      t(x["lo"]), t(x["hi"]))
        out.update({f"recv_pos{k}": ex.pos, f"recv_delta{k}": ex.delta,
                    f"range_sums{k}": ex.range_sums, f"cover{k}": cover,
                    f"dsum{k}": dsum})
        out.update({f"state{k}_{i}": s for i, s in enumerate(state)})
    return out


def step(x):
    fn = mesh.sharded_coverage_step(None, int(x["flags_mask"]),
                                    int(x["min_mapq"]), int(x["min_dep"]))
    cols = [t(x[f"{c}{rank}"]) for c in
            ("tid", "pos", "flag", "mapq", "opc", "opl", "opr")]
    cover, dsum = fn(*cols, *(t(x[k]) for k in
                              ("offsets", "limits", "bounds", "lo", "hi")))
    return {"cover": cover, "dsum": dsum}


def engine(x):
    eng = MultihostCoverageEngine(GenomeLayout(x["lengths"]), device="cpu")
    segs = (x["seg_tid"], x["s1"], x["e1"])
    eng.add_intervals(x[f"tid{rank}"], x[f"start{rank}"], x[f"end{rank}"])
    out = {}
    b1 = eng.segment_stats(*segs)
    kept = eng._blocks[0].state
    b2 = eng.segment_stats(*segs)
    b3 = eng.segment_stats(*segs, chunk=2)
    same = eng._blocks[0].state is kept
    n3 = eng.n_exchanges
    if rank == 0:   # a feed on one rank alone
        eng.add_intervals(np.zeros(1, np.int32), np.array([10]),
                          np.array([400]))
    b4 = eng.segment_stats(*segs)
    for k, b in enumerate((b1, b2, b3, b4)):
        out[f"cover{k + 1}"], out[f"dsum{k + 1}"] = b.cover, b.depth_sum
    out["exchanges"] = np.array([n3, eng.n_exchanges])
    out["same_state"] = np.array([int(same)])
    return out


def disagree(x):
    # rank 1 holds another layout: every rank refuses the exchange
    lengths = x["lengths"] + (rank == 1)
    eng = MultihostCoverageEngine(GenomeLayout(lengths), device="cpu")
    try:
        eng.exchange()
    except RuntimeError as e:
        return {"refused": np.array([int("disagree" in str(e))])}
    return {"refused": np.array([0])}


def save(name, out):
    np.savez(os.path.join(d, f"out_{name}_r{rank}.npz"),
             **{k: v.numpy() if isinstance(v, torch.Tensor) else v
                for k, v in out.items()})


init_multihost(f"file://{d}/store", world, rank, device="cpu")
assert dist.get_backend() == "gloo"
for name, kind in cases["collective"]:
    x = np.load(os.path.join(d, f"in_{name}.npz"))
    save(name, {"exchange": exchange, "step": step, "engine": engine,
                "disagree": disagree}[kind](x))
dist.barrier()
dist.destroy_process_group()

from pandepth_tpu_torch.sharding.launch import main
for k, (name, args) in enumerate(cases["cli"]):
    rc = main(["launch", "--coordinator", f"file://{d}/store_cli{k}",
               "--nprocs", str(world), "--rank", str(rank), "--backend",
               "gloo", "--device", "cpu", *args, "-o",
               os.path.join(d, f"cli_{name}_r{rank}")])
    save(name, {"rc": np.array([rc])})
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "pandepth_tpu"))
assert not bad, bad
print("DONE", rank, flush=True)
"""


# ----------------------------------------------------------------- inputs

def _tier_words(pos: np.ndarray, tier: str) -> np.ndarray:
    """int64 positions as the tier's words (the uint32 tier's as its
    int32 bit patterns, as the port carries them)."""
    np_dt, _ = TIER_OF[tier]
    w = pos.astype(np_dt)
    return w.view(np.int32) if np_dt is np.uint32 else w


def _events(tier: str, world: int, kind: str, seed: int):
    """Each rank's (pos int64, delta int32) with dead slots (delta 0,
    some at the tier's sentinel). ``random``: positions over the whole
    axis, some on the range cuts and one at ``layout.total``. ``hot``:
    every live event in range 0 but one at ``layout.total`` (the last
    range), deltas whose sum passes int32, rank 1 sending nothing."""
    lay = GenomeLayout(np.asarray(TIERS[tier], np.int64))
    bounds = lay.shard_bounds(world)
    sentinel = int(np.iinfo(TIER_OF[tier][0]).max)
    rng = np.random.RandomState(seed)
    out = []
    for r in range(world):
        m = 0 if kind == "hot" and r == 1 else 150 + 40 * r
        if kind == "random":
            pos = rng.randint(0, lay.total, m).astype(np.int64)
            pos[:world + 1] = bounds[:m][:world + 1]
            if m:
                pos[-1] = lay.total
        else:
            pos = rng.randint(0, 100, m).astype(np.int64)
        delta = rng.choice([-1, 1, 1, 2, 0], m).astype(np.int32)
        if kind == "hot" and m:
            delta[:3] = 1 << 30
            if r == 0:
                pos[-1], delta[-1] = lay.total, 1
        dead = rng.rand(m) < 0.1
        pos[dead & (rng.rand(m) < 0.5)] = sentinel
        delta[dead] = 0
        out.append((pos, delta))
    return lay, bounds, out


def _problem(n_dev, seed=1):
    """tests/test_sharding.py's ``_problem``: reads with a match and a
    deletion each over three contigs, and five segments."""
    rng = np.random.RandomState(seed)
    lengths = np.array([7000, 4000, 900], np.int64)
    layout = GenomeLayout(lengths)
    n = 32 * n_dev
    tid = rng.randint(0, 3, n).astype(np.int32)
    pos = rng.randint(0, 3500, n).astype(np.int32)
    flag = np.where(rng.rand(n) < 0.15, 256, 0).astype(np.int32)
    mapq = rng.randint(0, 61, n).astype(np.int32)
    opr = np.repeat(np.arange(n, dtype=np.int32), 2)
    opc = np.tile(np.array([0, 2], np.int32), n)  # M then D
    opl = rng.randint(1, 99, 2 * n).astype(np.int32)
    seg_tid = np.array([0, 0, 1, 2, 2], np.int32)
    s1 = np.array([1, 3000, 500, 1, 800], np.int64)
    e1 = np.array([3500, 7000, 4000, 900, 1200], np.int64)
    return layout, (tid, pos, flag, mapq, opc, opl, opr), (seg_tid, s1, e1)


def _hot_problem(n_dev):
    """tests/test_sharding.py's hot range: every read in range 0."""
    rng = np.random.RandomState(9)
    lengths = np.array([8000, 8000], np.int64)
    n = 32 * n_dev
    reads = (np.zeros(n, np.int32), rng.randint(0, 50, n).astype(np.int32),
             np.zeros(n, np.int32), np.full(n, 60, np.int32),
             np.zeros(n, np.int32), rng.randint(5, 40, n).astype(np.int32),
             np.arange(n, dtype=np.int32))
    return (GenomeLayout(lengths), reads,
            (np.array([0, 1], np.int32), np.ones(2, np.int64), lengths.copy()))


STEPS = {"problem": (_problem, dict(flags_mask=1796, min_mapq=20,
                                    min_dep=2)),
         "hot": (_hot_problem, dict(flags_mask=1796, min_mapq=-1,
                                    min_dep=1))}


def _step_segments(layout, segs):
    seg_tid, s1, e1 = segs
    lo = layout.offsets[seg_tid] + s1 - 1
    hi = np.minimum(layout.offsets[seg_tid] + e1, layout.limits[seg_tid])
    return lo.astype(np.int64), hi.astype(np.int64)


def _engine_problem():
    """tests/test_sharding.py's cached-state case: 600 intervals."""
    rng = np.random.RandomState(3)
    lengths = np.array([5000, 2600], np.int64)
    n = 600
    tid = rng.randint(0, 2, n).astype(np.int32)
    pos = rng.randint(0, 2400, n).astype(np.int64)
    ln = rng.randint(1, 180, n).astype(np.int64)
    segs = (np.array([0, 0, 1, 1], np.int32),
            np.array([1, 2000, 1, 700], np.int64),
            np.array([2500, 5000, 2600, 901], np.int64))
    return lengths, (tid, pos, pos + ln), segs


def _deep_bam(path: str, seed: int, n: int) -> None:
    """``n`` 150 bp reads, nearly all starting within 10 bp of one site:
    the pooled depth of two such samples passes 2^18."""
    rng = np.random.RandomState(seed)
    pos = np.sort(np.concatenate([rng.randint(100, 110, n - 500),
                                  rng.randint(0, 4800, 500)])).astype(np.int32)
    write_uniform_bam(path, ["chr1", "chr2"], [5000, 3000],
                      np.zeros(n, np.int32), pos, np.zeros(n, np.uint16),
                      np.full(n, 60, np.uint8), threads=1)


def _cli_cases(d: str):
    """The launcher's cases: (name, pandepth arguments, table kind)."""
    bams = [os.path.join(d, f"s{k}.bam") for k in range(3)]
    for k, path in enumerate(bams):
        make_bam(path, n=400 - 50 * k, seed=52 + k)
    bed = os.path.join(d, "t.bed")
    make_bed(bed)
    deep = [os.path.join(d, f"deep{k}.bam") for k in range(2)]
    for k, path in enumerate(deep):
        _deep_bam(path, 70 + k, 140_000)

    def lst(name, paths):
        p = os.path.join(d, f"{name}.list")
        with open(p, "w") as fh:
            fh.write("".join(f"{x}\n" for x in paths))
        return p

    two, three = lst("two", bams[:2]), lst("three", bams)
    return [("list2", ["-i", two], "chr"),
            ("list2_bed", ["-i", two, "-b", bed], "bed"),
            ("list3", ["-i", three], "chr"),
            ("one_bam", ["-i", bams[0]], "chr"),
            ("deep", ["-i", lst("deep", deep)], "chr"),
            ("site", ["-i", two, "-a"], None)]


def _run_jobs(d: str, jobs):
    """Start every job's ranks at once; wait for all of them. Returns
    each job's stdout per rank. A job whose rank fails, or which passes
    JOB_SECONDS, is killed whole and fails the test."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = {}
    for world in jobs:
        jd = os.path.join(d, f"w{world}")
        script = os.path.join(jd, "worker.py")
        with open(script, "w") as fh:
            fh.write(WORKER)
        procs[world] = [subprocess.Popen(
            [sys.executable, script, str(world), str(r), jd], cwd=jd, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for r in range(world)]
    deadline = time.monotonic() + JOB_SECONDS
    failed = None
    while failed is None and any(p.poll() is None
                                 for ps in procs.values() for p in ps):
        for world, ps in procs.items():
            bad = [p for p in ps if p.poll() not in (None, 0)]
            if bad:
                failed = (world, bad[0])
        if time.monotonic() > deadline:
            failed = (min(w for w, ps in procs.items()
                          if any(p.poll() is None for p in ps)), None)
        time.sleep(0.05)
    if failed is None:
        failed = next(((w, p) for w, ps in procs.items() for p in ps
                       if p.returncode != 0), None)
    if failed is not None:
        world, p = failed
        for ps in procs.values():
            for q in ps:
                q.kill()
        errs = [f"rank {r} exited {q.wait()}: {q.communicate()[1][-1500:]}"
                for r, q in enumerate(procs[world])]
        why = "a rank failed" if p is not None else \
            f"timed out after {JOB_SECONDS} s"
        pytest.fail(f"the world-{world} job: {why}\n" + "\n".join(errs))
    return {w: [p.communicate()[0] for p in ps] for w, ps in procs.items()}


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """Every case's inputs, then the three jobs. Returns the directory of
    each world's job and the case descriptions."""
    d = str(tmp_path_factory.mktemp("multihost"))
    assert native.load_library() is not None   # built before the ranks
    cases = {}
    for world in WORLDS:
        jd = os.path.join(d, f"w{world}")
        os.makedirs(jd)
        coll = []
        for tier in TIERS:
            for seed, kind in enumerate(VARIANTS):
                lay, bounds, evs = _events(tier, world, kind, seed)
                lo, hi = _seg_bounds(lay, *_segments(lay))
                np_dt, tier_id = TIER_OF[tier]
                arrays = {f"pos{r}": _tier_words(p, tier)
                          for r, (p, _) in enumerate(evs)}
                arrays.update({f"delta{r}": dl for r, (_, dl) in
                               enumerate(evs)})
                name = f"ex_{tier}_{kind}"
                np.savez(os.path.join(jd, f"in_{name}.npz"), bounds=bounds,
                         tier=tier_id, lo=lo, hi=hi,
                         pos_max=int(np.iinfo(np_dt).max),
                         variants=np.array(VARIANTS[kind], np.int64),
                         **arrays)
                coll.append((name, "exchange"))
                cases[(world, name)] = (lay, bounds, evs, lo, hi)
        if world > 1:
            for kind, (make, kw) in STEPS.items():
                layout, reads, segs = make(world)
                per = reads[0].shape[0] // world
                cols = {}
                for r in range(world):
                    rows = slice(r * per, (r + 1) * per)
                    ops = (reads[6] >= r * per) & (reads[6] < (r + 1) * per)
                    for c, a in zip(("tid", "pos", "flag", "mapq"), reads):
                        cols[f"{c}{r}"] = a[rows]
                    for c, a in zip(("opc", "opl"), reads[4:6]):
                        cols[f"{c}{r}"] = a[ops]
                    cols[f"opr{r}"] = (reads[6][ops] - r * per).astype(
                        np.int32)
                lo, hi = _step_segments(layout, segs)
                name = f"step_{kind}"
                np.savez(os.path.join(jd, f"in_{name}.npz"),
                         offsets=layout.offsets, limits=layout.limits,
                         bounds=layout.shard_bounds(world), lo=lo, hi=hi,
                         **kw, **cols)
                coll.append((name, "step"))
                cases[(world, name)] = (layout, reads, segs, kw)
        cli = []
        if world == 2:
            lengths, (tid, s, e), segs = _engine_problem()
            parts = {f"{c}{r}": a[r::world] for r in range(world)
                     for c, a in (("tid", tid), ("start", s), ("end", e))}
            np.savez(os.path.join(jd, "in_engine.npz"), lengths=lengths,
                     seg_tid=segs[0], s1=segs[1], e1=segs[2], **parts)
            coll.append(("engine", "engine"))
            np.savez(os.path.join(jd, "in_disagree.npz"), lengths=lengths)
            coll.append(("disagree", "disagree"))
            cli = _cli_cases(jd)
            cases["cli"] = cli
        with open(os.path.join(jd, "cases.json"), "w") as fh:
            json.dump({"collective": coll,
                       "cli": [(n, a) for n, a, _ in cli]}, fh)
    out = _run_jobs(d, WORLDS)
    for world in WORLDS:
        assert [ln for o in out[world] for ln in o.splitlines()
                if ln.startswith("DONE")] == \
            [f"DONE {r}" for r in range(world)]
    return d, cases


def _seg_bounds(lay, seg_tid, seg_start, seg_end):
    """The sharded engines' global [lo, hi) of 1-based segments."""
    lo = lay.offsets[seg_tid] + np.maximum(seg_start - 1, 0)
    hi = np.minimum(lay.offsets[seg_tid] + seg_end, lay.limits[seg_tid])
    lo = np.minimum(lo, lay.limits[seg_tid])
    return lo.astype(np.int64), np.maximum(hi, lo).astype(np.int64)


def _out(d, world, name, rank):
    return np.load(os.path.join(d, f"w{world}", f"out_{name}_r{rank}.npz"))


# ---------------------------------------------------------------- JAX side

def _flat(n):
    return Mesh(np.asarray(jax.devices()[:n]), ("x",))


def _jax_rows(evs, tier):
    """Every rank's events as one row each, padded to one width with the
    tier's sentinel and delta 0 (dead slots, which JAX sends nowhere)."""
    np_dt = TIER_OF[tier][0]
    width = max(max(p.shape[0] for p, _ in evs), 1)
    rows_p = np.full((len(evs), width), np.iinfo(np_dt).max, np_dt)
    rows_d = np.zeros((len(evs), width), np.int32)
    for r, (p, dl) in enumerate(evs):
        rows_p[r, :p.shape[0]] = p.astype(np_dt)
        rows_d[r, :p.shape[0]] = dl
    return rows_p, rows_d


def _jax_exchange(evs, bounds, tier):
    """JAX's ``_bucket_exchange`` under shard_map, one device a rank, at a
    capacity no bucket can overflow: each device's received rows with each
    source's padding removed, and its carry."""
    n = len(evs)
    rows_p, rows_d = _jax_rows(evs, tier)
    cap = rows_p.shape[1]

    def body(p, dl, b):
        rp, rd, carry, overflow, _, _ = jax_mesh._bucket_exchange(
            p[0], dl[0], b, n, cap)
        return rp[None], rd[None], carry[None], overflow

    fn = jax.jit(jax_mesh.shard_map_fn(
        body, _flat(n), in_specs=(P("x", None), P("x", None), P()),
        out_specs=(P("x", None), P("x", None), P("x"), P())))
    rp, rd, carry, overflow = (np.asarray(x) for x in
                               fn(rows_p, rows_d, bounds))
    assert int(overflow) == 0
    live = rd != 0
    return [(rp[r][live[r]], rd[r][live[r]]) for r in range(n)], carry


def _numpy_bucket(pos, delta, bounds):
    """A stable bucketing in numpy: (events by destination, counts,
    sums)."""
    world = bounds.shape[0] - 1
    dest = np.minimum(np.searchsorted(bounds[1:-1], pos, side="right"),
                      world - 1)
    dest = np.where(delta != 0, dest, world)
    order = np.argsort(dest, kind="stable")
    n = int((delta != 0).sum())
    sums = np.zeros(world + 1, np.int64)
    np.add.at(sums, dest, delta.astype(np.int64))
    return (pos[order][:n], delta[order][:n],
            np.bincount(dest, minlength=world + 1)[:world], sums[:world])


def _int32_wrap(x: int) -> int:
    return int(np.array(x, np.int64).astype(np.int32))


# ------------------------------------------------------------------ tests

@pytest.mark.parametrize("kind", list(VARIANTS))
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tier", list(TIERS))
def test_bucket_events_reference_matches_numpy(tier, world, kind):
    """The twin, in this process, on each rank's events: the live events
    in stable destination order, each range's count and delta sum."""
    _, bounds, evs = _events(tier, world, kind, list(VARIANTS).index(kind))
    tb = torch.from_numpy(bounds)
    for pos, delta in evs:
        got = mesh.bucket_events(torch.from_numpy(_tier_words(pos, tier)),
                                 torch.from_numpy(delta), tb,
                                 TIER_OF[tier][1])
        want = _numpy_bucket(pos, delta, bounds)
        n = int(got[2].sum())
        np.testing.assert_array_equal(_tier_words(want[0], tier),
                                      got[0][:n].numpy())
        np.testing.assert_array_equal(want[1], got[1][:n].numpy())
        np.testing.assert_array_equal(want[2], got[2].numpy())
        np.testing.assert_array_equal(want[3], got[3].numpy())
        assert got[2].dtype == torch.int32 and got[3].dtype == torch.int64


BUCKET_EDGES = synth.bucket_edge_events(seed=7)


@pytest.mark.parametrize("case", range(len(BUCKET_EDGES)),
                         ids=[c[0] for c in BUCKET_EDGES])
def test_bucket_events_tile_edges_match_jax(case):
    """The edges of the bucket_events kernel's tiles and look-back (the
    cases chip_smoke.py holds the kernel to its twin on), through the
    twin: over at most 8 ranges against JAX's ``_bucket_exchange`` with
    every event on one rank (the events each range receives, in order,
    and the carry), over more against numpy; and against numpy's counts
    and sums."""
    name, pos, delta, np_dt, bounds = BUCKET_EDGES[case]
    tier = np.dtype(np_dt).name
    world = bounds.shape[0] - 1
    got = mesh.bucket_events(torch.from_numpy(_tier_words(pos, tier)),
                             torch.from_numpy(delta),
                             torch.from_numpy(bounds), TIER_OF[tier][1])
    n = int(got[2].sum())
    want = _numpy_bucket(pos, delta, bounds)
    np.testing.assert_array_equal(want[2], got[2].numpy())
    np.testing.assert_array_equal(want[3], got[3].numpy())
    if world <= 8:
        none = (pos[:0], delta[:0])
        recv, carry = _jax_exchange([(pos, delta)] + [none] * (world - 1),
                                    bounds, tier)
        want = (np.concatenate([p for p, _ in recv]).astype(np.int64),
                np.concatenate([d for _, d in recv]))
        assert [p.shape[0] for p, _ in recv] == got[2].tolist()
        sums = got[3].numpy()
        assert [_int32_wrap(int(sums[:r].sum())) for r in range(world)] \
            == [int(c) for c in carry]
    np.testing.assert_array_equal(_tier_words(want[0], tier),
                                  got[0][:n].numpy())
    np.testing.assert_array_equal(want[1], got[1][:n].numpy())


def test_bucket_edge_events_reach_their_edges():
    """Each case of ``synth.bucket_edge_events`` puts its events where its
    name says, relative to the kernel's tiles and the ranges."""
    t = synth.BUCKET_TILE
    sizes, worlds = set(), set()
    for name, pos, delta, np_dt, bounds in BUCKET_EDGES:
        world = bounds.shape[0] - 1
        worlds.add(world)
        sizes.add(pos.shape[0])
        live = delta != 0
        dest = np.minimum(np.searchsorted(bounds[1:-1], pos, side="right"),
                          world - 1)
        if "change" in name:
            assert dest[t] != dest[t - 1]
            assert dest[2 * t - 1] != dest[2 * t - 2]
            assert live.all()
        elif "all-dead" in name:
            assert not live[t:2 * t].any() and live[:t].any()
        elif "empty" in name:
            assert not (live & (dest == 3)).any()
            assert all((live & (dest == d)).any() for d in (0, 2, 4, 7))
        elif "hot" in name:
            assert (dest[live][:-1] == 0).all() and dest[-1] == world - 1
        elif pos.shape[0] > 1:
            assert pos[-1] == bounds[-1] and live[-1]
            assert (~live).any() and (pos[~live] == np.iinfo(np_dt).max).any()
    assert {0, 1, t - 1, t, t + 1} <= sizes
    assert {1, 2, 8, 1024} <= worlds


@pytest.mark.parametrize("kind", list(VARIANTS))
@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("tier", list(TIERS))
def test_exchange_matches_jax_bucket_exchange(jobs, tier, world, kind):
    """Each rank's local bucketing, the events it received (in order) and
    its carry against JAX's ``_bucket_exchange``."""
    d, cases = jobs
    name = f"ex_{tier}_{kind}"
    lay, bounds, evs, _, _ = cases[(world, name)]
    recv, carry = _jax_exchange(evs, bounds, tier)
    if kind == "hot" and world > 1:
        assert not any(recv[r][0].shape[0] for r in range(1, world - 1))
        assert np.abs(np.array([int(carry[r]) for r in range(world)])).max() \
            <= (1 << 31) and sum(int(x) for x in evs[0][1]) > (1 << 31)
    for r in range(world):
        out = _out(d, world, name, r)
        want = _numpy_bucket(*evs[r], bounds)
        np.testing.assert_array_equal(out["local_pos"],
                                      _tier_words(want[0], tier))
        for k, key in enumerate(("local_delta", "counts", "sums"), 1):
            np.testing.assert_array_equal(out[key], want[k])
        got_pos = out["recv_pos0"]
        if tier == "uint32":
            got_pos = got_pos.view(np.uint32)
        np.testing.assert_array_equal(got_pos, recv[r][0])
        np.testing.assert_array_equal(out["recv_delta0"], recv[r][1])
        sums = out["range_sums0"]
        assert _int32_wrap(int(sums[:r].sum())) == int(carry[r])
        assert int(sums.sum()) == sum(int(dl.sum()) for _, dl in evs)


@pytest.mark.parametrize("kind", list(VARIANTS))
@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("tier", list(TIERS))
def test_exchange_finalize_matches_jax(jobs, tier, world, kind):
    """``exchange_sorted`` + ``state_eval`` against
    ``_events_exchange_finalize`` for each (wrap18, min_dep) variant: every
    rank's state on its first 1 + received slots, and (cover, dsum)."""
    d, cases = jobs
    name = f"ex_{tier}_{kind}"
    lay, bounds, evs, lo, hi = cases[(world, name)]
    rows_p, rows_d = _jax_rows(evs, tier)
    for k, (wrap18, min_dep) in enumerate(VARIANTS[kind]):
        fin = jax_mesh._events_exchange_finalize(_flat(world), world,
                                                 rows_p.shape[1], min_dep,
                                                 wrap18)
        jout = [np.asarray(x) for x in fin(rows_p, rows_d, bounds, lo, hi)]
        assert int(jout[2]) == 0
        assert np.asarray(jout[4]).any()
        for r in range(world):
            out = _out(d, world, name, r)
            np.testing.assert_array_equal(out[f"cover{k}"], jout[0])
            np.testing.assert_array_equal(out[f"dsum{k}"], jout[1])
            n = 1 + out[f"recv_pos{k}"].shape[0]
            for i in range(4):
                got = out[f"state{k}_{i}"]
                assert got.shape[0] == 1
                np.testing.assert_array_equal(
                    got[0, :n].astype(np.int64),
                    jout[3 + i][r, :n].astype(np.int64))


@pytest.mark.parametrize("kind", list(STEPS))
@pytest.mark.parametrize("world", [2, 4])
def test_sharded_coverage_step_matches_jax(jobs, world, kind):
    """The port's step on each rank's local reads against JAX's
    ``sharded_coverage_step`` over as many devices, and the single-device
    engine."""
    d, cases = jobs
    layout, reads, segs, kw = cases[(world, f"step_{kind}")]
    tid, pos, flag, mapq, opc, opl, opr = reads
    per = tid.shape[0] // world
    step = jax_mesh.sharded_coverage_step(
        jax_mesh.make_mesh(jax.devices()[:world], dp=1), **kw)
    lo, hi = _step_segments(layout, segs)
    cover, dsum = step(tid, pos, flag, mapq, opc, opl,
                       (opr % per).astype(np.int32), layout.offsets,
                       layout.limits, layout.shard_bounds(world), lo, hi)
    eng = JaxEngine(layout, **kw)
    eng.add_batch(ReadBatch(tid, pos, flag, mapq,
                            np.bincount(opr, minlength=tid.shape[0]).astype(
                                np.int32), opc, opl, opr))
    st = eng.segment_stats(*segs)
    np.testing.assert_array_equal(np.asarray(cover), st.cover)
    for r in range(world):
        out = _out(d, world, f"step_{kind}", r)
        np.testing.assert_array_equal(out["cover"], np.asarray(cover))
        np.testing.assert_array_equal(out["dsum"], np.asarray(dsum))
    assert st.cover.any()


def test_multihost_engine_matches_jax(jobs):
    """tests/test_sharding.py's cached-state case on 2 ranks, each fed
    half the intervals: equal to JAX's MultihostCoverageEngine and the
    single-device engine on every call; one exchange until a feed (on
    rank 0 alone) makes both ranks exchange again."""
    d, _ = jobs
    lengths, (tid, s, e), segs = _engine_problem()
    layout = GenomeLayout(lengths)
    ref, jmh = JaxEngine(layout), JaxMultihost(layout)
    for eng in (ref, jmh):
        eng.add_intervals(tid, s, e)
    want = [ref.segment_stats(*segs)]
    want += [want[0], ref.segment_stats(*segs, chunk=2)]
    jwant = [jmh.segment_stats(*segs), jmh.segment_stats(*segs),
             jmh.segment_stats(*segs, chunk=2)]
    for eng in (ref, jmh):
        eng.add_intervals(np.zeros(1, np.int32), np.array([10]),
                          np.array([400]))
    want.append(ref.segment_stats(*segs))
    jwant.append(jmh.segment_stats(*segs))
    for w, j in zip(want, jwant):
        np.testing.assert_array_equal(j.cover, w.cover)
        np.testing.assert_array_equal(j.depth_sum, w.depth_sum)
    for r in range(2):
        out = _out(d, 2, "engine", r)
        for k, w in enumerate(want, 1):
            np.testing.assert_array_equal(out[f"cover{k}"], w.cover)
            np.testing.assert_array_equal(out[f"dsum{k}"], w.depth_sum)
        assert out["exchanges"].tolist() == [1, 2]
        assert out["same_state"].tolist() == [1]


@pytest.mark.parametrize("case", ["list2", "list2_bed", "list3", "one_bam",
                                  "deep"])
def test_launcher_tables_match_single_process(jobs, tmp_path, case):
    """Rank 0's table byte-equal to the port's and the JAX package's
    single-process CLI on the same arguments; rank 1 writes none."""
    d, cases = jobs
    name, args, kind = next(c for c in cases["cli"] if c[0] == case)
    jd = os.path.join(d, "w2")
    for r in range(2):
        assert _out(d, 2, name, r)["rc"].tolist() == [0]
    assert not os.path.exists(os.path.join(jd, f"cli_{name}_r1.{kind}"
                                               f".stat.gz"))
    got = gunzip_bytes(os.path.join(jd, f"cli_{name}_r0.{kind}.stat.gz"))
    port = str(tmp_path / "port")
    assert port_main(["pandepth", *args, "-o", port], device="cpu") == 0
    assert gunzip_bytes(f"{port}.{kind}.stat.gz") == got
    jx = str(tmp_path / "jax")
    assert jax_main(["pandepth", *args, "-o", jx]) == 0
    assert gunzip_bytes(f"{jx}.{kind}.stat.gz") == got
    assert len(got.splitlines()) > 1


def test_deep_list_wraps_on_the_whole_list(jobs):
    """The deep .list's pooled depth passes 2^18, so the 18-bit wrap of a
    multi-file run changes chr1's total depth: the launcher's table holds
    the wrapped total (the single-process run's, above), not the one a
    run deciding per rank, on one file each, would write."""
    d, _ = jobs
    got = gunzip_bytes(os.path.join(d, "w2", "cli_deep_r0.chr.stat.gz"))
    lay = GenomeLayout(np.array([5000, 3000], np.int64))
    totals = []
    for wrap18 in (False, True):
        eng = JaxEngine(lay, wrap18=wrap18)
        for k in range(2):
            rng = np.random.RandomState(70 + k)
            n = 140_000
            pos = np.concatenate([rng.randint(100, 110, n - 500),
                                  rng.randint(0, 4800, 500)]).astype(np.int64)
            eng.add_intervals(np.zeros(n, np.int32), pos, pos + 150)
        totals.append(str(int(eng.segment_stats(
            np.array([0], np.int32), np.array([1]),
            np.array([5000])).depth_sum[0])))
    chr1 = next(ln.split("\t") for ln in got.decode().splitlines()
                if ln.startswith("chr1\t"))
    assert totals[0] != totals[1]
    assert totals[1] in chr1 and totals[0] not in chr1


def test_ranks_that_disagree_refuse_the_exchange(jobs):
    """A rank whose layout differs from rank 0's: every rank raises
    before any event is exchanged."""
    d, _ = jobs
    for r in range(2):
        assert _out(d, 2, "disagree", r)["refused"].tolist() == [1]


def test_unported_flag_exits_2_on_every_rank(jobs):
    d, cases = jobs
    for r in range(2):
        assert _out(d, 2, "site", r)["rc"].tolist() == [2]


FAIL_SECONDS = 60


@pytest.mark.parametrize("bad", ["corrupt_bam", "missing_file"])
def test_rank_local_failure_exits_every_rank(tmp_path, bad):
    """A 2-rank gloo job through the launcher whose rank 1 holds a list
    member it cannot stage (a .bam of garbage bytes, or a path that does
    not exist): both ranks exit non-zero within FAIL_SECONDS, rank 1 names
    its file, rank 0 says that another rank failed, and no table is
    written."""
    assert native.load_library() is not None   # built before the ranks
    good = str(tmp_path / "good.bam")
    make_bam(good, n=300, seed=61)
    member = str(tmp_path / "bad.bam")
    if bad == "corrupt_bam":   # gzip's magic, then garbage
        with open(member, "wb") as fh:
            fh.write(b"\x1f\x8b" + np.random.RandomState(4).bytes(5000))
    lst = tmp_path / "in.list"
    lst.write_text(f"{good}\n{member}\n")
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-m", "pandepth_tpu_torch.sharding.launch",
         "--coordinator", f"file://{tmp_path}/store", "--nprocs", "2",
         "--rank", str(r), "--backend", "gloo", "--device", "cpu", "-i",
         str(lst), "-o", str(tmp_path / f"out{r}")], cwd=str(tmp_path),
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    deadline = time.monotonic() + FAIL_SECONDS
    while any(p.poll() is None for p in procs) \
            and time.monotonic() < deadline:
        time.sleep(0.05)
    hung = [r for r, p in enumerate(procs) if p.poll() is None]
    for p in procs:
        p.kill()
    errs = [p.communicate()[1] for p in procs]
    assert not hung, f"ranks {hung} still running after {FAIL_SECONDS} s: " \
                     + "\n".join(e[-1500:] for e in errs)
    assert [p.returncode != 0 for p in procs] == [True, True], errs
    assert member in errs[1], errs[1][-2000:]
    # rank 0 learns it from the job's decision, not from a torn-down group
    assert "another rank of the job failed to stage" in errs[0], errs[0]
    assert not list(tmp_path.glob("*.stat.gz"))


def test_process_read_shard_and_init_refusals(monkeypatch):
    """File k goes to rank k mod P, a rank may get none; no CUDA device,
    or NCCL on the CPU, raises before any group is joined."""
    paths = ["a", "b", "c"]
    assert distributed.process_read_shard(paths, 0, 2) == [(0, "a"),
                                                           (2, "c")]
    assert distributed.process_read_shard(paths, 1, 2) == [(1, "b")]
    assert distributed.process_read_shard(paths[:1], 1, 2) == []
    with pytest.raises(RuntimeError, match="CUDA"):
        distributed.init_multihost("localhost:1", 1, 0)
    with pytest.raises(ValueError, match="nccl"):
        distributed.init_multihost("localhost:1", 1, 0, backend="nccl",
                                   device="cpu")
    with pytest.raises(ValueError, match="rank"):
        distributed.init_multihost("localhost:1", 2, 2, device="cpu")
    assert not torch.distributed.is_initialized()


def test_bucket_events_kernel_takes_no_cpu_tensors():
    """The CUDA wrapper launches on CUDA tensors or raises; the CPU runs
    the twin only through ``mesh.bucket_events``."""
    pos = torch.zeros(5, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.bucket_events(pos, torch.ones(5, dtype=torch.int32),
                              torch.tensor([0, 3, 9]), kernels.TIER_I32)
