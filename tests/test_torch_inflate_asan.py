"""AddressSanitizer and UndefinedBehaviorSanitizer run of the port's BGZF
inflate: the port's pancov_io.cpp + tests/asan_harness_inflate.cpp built
with -fsanitize=address,undefined and run on the valid and mutated streams
of tests/test_torch_inflate.py: every block of a benchmark-shaped and of a
literal-heavy BAM, zlib's levels and strategies, the hand-made edges,
fast-loop margins and rule breaks, 3,000 seeded mutations, and every
stream that inflates with an expected length one short and one long.
Each payload and its 8 trailer bytes end exactly where their allocation
ends, and each output is allocated to exactly its expected length. Any
read or write outside them, or undefined behaviour, makes the harness
exit nonzero, as does a verdict or an output other than zlib's. The same
harness with an output or a payload allocation one byte short must be
caught: the check bites."""

import os
import random
import struct
import subprocess
import zlib

import pytest

from tests import test_torch_inflate as infl

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "..", "pandepth_tpu_torch", "io", "native",
                    "pancov_io.cpp")
_HARNESS = os.path.join(_HERE, "asan_harness_inflate.cpp")
_ENV = dict(os.environ, ASAN_OPTIONS="detect_leaks=0:halt_on_error=1",
            UBSAN_OPTIONS="print_stacktrace=1:halt_on_error=1")

bams = infl.bams


@pytest.fixture(scope="module")
def harness(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("asan") / "harness")
    r = subprocess.run(
        ["g++", "-std=c++17", "-O1", "-g", "-fno-omit-frame-pointer",
         "-fsanitize=address,undefined", "-fno-sanitize-recover=all", "-o",
         out, _SRC, _HARNESS, "-lz", "-lpthread"],
        capture_output=True, text=True, timeout=600)
    if r.returncode != 0:
        pytest.fail(f"ASan build failed: {r.stderr[-1500:]}")
    return out


@pytest.fixture(scope="module")
def corpus(bams, tmp_path_factory):
    cases = [(p, n) for kind in ("chr", "literal")
             for p, n in infl.bgzf_blocks(bams[kind])]
    for data in infl._corpus(bams):
        for level in range(10):
            for strategy in infl.STRATEGIES:
                cases.append((infl.deflate(data, level, strategy),
                              len(data)))
    for blocks in infl.EDGES.values():
        p = infl.written(*blocks)
        cases.append((p, len(zlib.decompress(p, -15))))
    for streams in infl.MARGIN_STREAMS.values():
        cases += [(p, 600) for p in streams]
    for spec, n, _ in infl.RULES.values():
        cases.append((infl._rule_payload(spec), n))
    rng = random.Random(99)
    bases = infl._mutation_bases(bams)
    for _ in range(3000):
        p, n = rng.choice(bases)
        cases.append((infl._mutants(rng, p), n))
    # an expected length off by one
    cases += [(p, n + dn) for p, n in list(cases) for dn in (-1, 1)
              if n + dn >= 0 and infl.theirs(p, n) is not None]
    path = str(tmp_path_factory.mktemp("asan") / "corpus.bin")
    n_ok = 0
    with open(path, "wb") as fh:
        for p, n in cases:
            want = infl.theirs(p, n)
            n_ok += want is not None
            fh.write(struct.pack("<IIBI", len(p), n, want is not None,
                                 zlib.crc32(want or b"")) + p)
    return path, len(cases), n_ok


def test_inflate_under_asan(harness, corpus):
    path, n, n_ok = corpus
    assert 500 < n_ok < n - 500  # both verdicts, many times
    r = subprocess.run([harness, path, "exact"], capture_output=True,
                       text=True, timeout=600, env=_ENV)
    assert "Sanitizer" not in r.stderr and "runtime error" not in r.stderr, \
        r.stderr[-4000:]
    assert r.returncode == 0, (r.returncode, r.stdout, r.stderr[-4000:])
    assert f"cases={n} ok={n_ok} wrong=0" in r.stdout, r.stdout


@pytest.mark.parametrize("mode", ["short_dst", "short_src"])
def test_asan_catches_one_byte_over(harness, corpus, mode):
    r = subprocess.run([harness, corpus[0], mode], capture_output=True,
                       text=True, timeout=600, env=_ENV)
    assert r.returncode != 0
    assert "heap-buffer-overflow" in r.stderr, r.stderr[-2000:]
